"""Process start to the window's opening: imports, the kernels' build when
stale, the checkpoint, the model's weights, graph captures and warm-up."""


def read(run):
    return run.setup_s
