"""The control of each comparison at a size a test run holds: the answers
of the plain reference computed in the precision below the
configuration's (int4 weights where it states int8), put in the program's
place on the same sample of the timed path's answers and judged by the
cell's own check and limit, must come out ``correct`` false and read far
above the program.  The same readings at the cells' own sizes, on the
card, set the limits (``tools/control.py``)."""

import time

import pytest

from conftest import tiny_llm, tiny_resnet


def _control(workload, cell, cfg, seed, device="cpu"):
    from benchmark import run as bench_run

    run = bench_run.make_run(workload, seed, 2.5, False, device, cell=cell,
                             config=cfg, t_start=time.perf_counter())
    run.info["control"] = True
    line = bench_run.execute(run)
    return line, run.info["control_line"]


def _judged(line, ctl):
    """The program's line is correct, the control's in its place is not,
    and the control reads at least three times the program."""
    (name, got), = line["checks"].items()
    assert line["correct"] is True
    assert ctl["correct"] is False
    assert ctl["checks"][name]["value"] > got["limit"]
    assert ctl["checks"][name]["value"] >= 3 * got["value"]


@pytest.mark.parametrize("workload", ["sc2-7b.decode", "sc2-7b.complete"])
def test_llm_control_reads_far_above_the_program(workload):
    cell, cfg = tiny_llm(workload)
    _judged(*_control(workload, cell, cfg, 2**31 + 21))


def test_resnet_control_reads_far_above_the_program():
    cell, cfg = tiny_resnet()
    _judged(*_control("resnet50-int8.batch", cell, cfg, 2**31 + 22))


@pytest.mark.card
@pytest.mark.parametrize("workload", ["sc2-7b.decode",
                                      "resnet50-int8.batch"])
def test_tiny_cell_on_the_card(cuda, workload):
    """The cell's path with the port's kernels at a tiny size."""
    cell, cfg = (tiny_resnet() if workload.startswith("resnet")
                 else tiny_llm(workload))
    _judged(*_control(workload, cell, cfg, 2**31 + 23, device=cuda))
