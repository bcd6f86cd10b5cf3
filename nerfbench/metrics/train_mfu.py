"""train_mfu (%): a step's model FLOPs (``work.train_flops_per_step``, the
port's ``session.estimate_flops_per_step`` arithmetic) times the window's
steps, over the window (timed before the profiler starts), over the card's
dense bf16 peak."""

from nerfbench import work
from nerfbench.metrics._common import card_peaks


def read(run):
    pk = card_peaks(run)
    if run.cell.job != "train" or pk is None or run.window_s <= 0:
        return None
    flops = work.train_flops_per_step(run.cfg, run.ref) * run.units
    return 100.0 * flops / run.window_s / pk["flops"]
