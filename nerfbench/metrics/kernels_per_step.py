"""kernels_per_step (count): device kernels in the traced stretch per
train step."""

from nerfbench.metrics._common import traced


def read(run):
    if not traced(run, "train"):
        return None
    return len(run.trace.kernels()) / run.traced_units
