"""hash_roofline.train (%): the least time of the hash encode, forward and
backward, by bytes (points in, features out, the table read once; the
features' gradient and the points in, the table's gradient written once),
over the device time inside the spans of the encode and its backward."""

from nerfbench import work
from nerfbench.metrics._common import card_peaks, traced


def read(run):
    pk = card_peaks(run)
    if pk is None or not traced(run, "train") or not hasattr(run.ref, "encode_bytes"):
        return None
    busy = run.span_trace.device_time(["encode", "encode_bwd"])
    if not busy:
        return None
    least = work.encode_least_s(run.cfg, run.ref, work.points_per_step(run.cfg), True, pk)
    return 100.0 * least * run.traced_units / busy
