"""setup_s: seconds from process start to the window's start (loading,
drawing the model, the kernel build on a checkout's first run, warming the
cell's shapes and bringing its traffic to a steady state)."""


def read(run):
    return run.setup_s
