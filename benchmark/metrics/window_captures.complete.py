"""``window_captures.complete`` (programs): CUDA-graph captures made
inside the window, over every program of the engine: shapes the warm-up
missed, each paid on a request's path."""


def read(run):
    return run.delta("window", lambda c: sum(p["captures"]
                                             for p in c.values()))
