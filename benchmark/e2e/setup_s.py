"""``setup_s``: seconds from the process's start to the start of the load:
imports, the weights, the engine or the deployment, the kernel library
(built there in a checkout's first run), and the warm-up of every shape
the cell uses."""


def read(run):
    return run.setup_s
