"""setup_s: the start of the process to the start of the window: imports, the build of
the cell's kernels (none after a checkout's first run), the scene, the weights and the
warm-up."""


def read(w):
    return w.setup_s
