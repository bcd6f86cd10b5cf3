"""vm_roofline.train (%): the least time of the VM encode, forward and
backward, by bytes (``reference/tensorf.encode_bytes``: points in, the
density feature and the appearance products out, the factors read once;
the cotangents and the points in, the factors' gradients written once),
over the device time of the VM kernels in the device-only pass, found by
their names. The zeroing of the gradients before the backward kernel is
not counted. None where the trace holds no VM kernel."""

from nerfbench import work
from nerfbench.metrics._common import card_peaks, traced

KERNELS = ("vm_encode_fwd_kernel", "vm_encode_bwd_kernel")


def read(run):
    pk = card_peaks(run)
    if pk is None or not traced(run, "train") or not hasattr(run.ref, "encode_bytes"):
        return None
    busy = sum(op.end - op.start for op in run.trace.ops if any(k in op.name for k in KERNELS))
    if not busy:
        return None
    least = work.encode_least_s(run.cfg, run.ref, work.points_per_step(run.cfg), True, pk)
    return 100.0 * least * run.traced_units / busy
