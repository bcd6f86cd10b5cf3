"""render_mfu (%): a frame's forward FLOPs (2 x multiply-adds x pixels x
samples a ray) times the window's frames, over the window, over the card's
dense bf16 peak."""

from nerfbench import work
from nerfbench.metrics._common import card_peaks


def read(run):
    pk = card_peaks(run)
    if run.cell.job != "render" or pk is None or run.window_s <= 0:
        return None
    flops = work.frame_flops(run.cfg, run.ref, run.rays_per_unit) * run.units
    return 100.0 * flops / run.window_s / pk["flops"]
