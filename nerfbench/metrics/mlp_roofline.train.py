"""mlp_roofline.train (%): the least time of a step's MLP work, forward and
backward on the step's points (``work.mlp_train_least_s``), over the device
time of every operation launched inside the span around the port's
``fused_train_pass``, per step. Nothing to read where no pass runs."""

from nerfbench import work
from nerfbench.metrics._common import card_peaks, traced


def read(run):
    pk = card_peaks(run)
    if pk is None or not traced(run, "train"):
        return None
    busy = run.span_trace.device_time(["field_pass"])
    if not busy:
        return None
    return 100.0 * work.mlp_train_least_s(run.cfg, run.ref, pk) * run.traced_units / busy
