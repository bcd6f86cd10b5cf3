"""setup_s (s): from the start of the process to the first timed step or
frame: imports, the kernels' build on a checkout's first run, inputs on the
device, the warm-up."""


def read(run):
    return run.setup_s
