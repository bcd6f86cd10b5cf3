"""mlp_roofline.render (%): the least time of the MLP forward over the
frames' points (each pixel's coarse and fine samples), over the device time of every
operation launched inside the span around the port's ``fused_nerf_apply``.
Nothing to read where that entry does not run."""

from nerfbench import work
from nerfbench.metrics._common import card_peaks, traced


def read(run):
    pk = card_peaks(run)
    if pk is None or not traced(run, "render"):
        return None
    busy = run.span_trace.device_time(["field_fwd"])
    if not busy:
        return None
    points = run.traced_units * run.rays_per_unit * work.samples_per_ray(run.cfg)
    return 100.0 * work.mlp_forward_least_s(run.cfg, run.ref, points, pk) / busy
