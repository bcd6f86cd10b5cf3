"""hash_roofline.render (%): the least time of the hash encode's forward by
bytes, each pixel's samples once, over the device time inside the encode's
spans."""

from nerfbench import work
from nerfbench.metrics._common import card_peaks, traced


def read(run):
    pk = card_peaks(run)
    if pk is None or not traced(run, "render") or not hasattr(run.ref, "encode_bytes"):
        return None
    busy = run.span_trace.device_time(["encode"])
    if not busy:
        return None
    points = run.traced_units * run.rays_per_unit * work.samples_per_ray(run.cfg)
    return 100.0 * work.encode_least_s(run.cfg, run.ref, points, False, pk) / busy
