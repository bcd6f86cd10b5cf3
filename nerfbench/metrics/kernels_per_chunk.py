"""kernels_per_chunk (count): device kernels in the traced stretch per
render chunk (frames x chunks a frame)."""

from nerfbench.metrics._common import traced


def read(run):
    if not traced(run, "render"):
        return None
    return len(run.trace.kernels()) / (run.traced_units * run.chunks_per_frame)
