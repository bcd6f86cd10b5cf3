"""render_rays_per_s (rays/s): the pixels of every frame finished in the
window over the window's length, frames back to back."""


def read(run):
    if run.cell.job != "render" or run.window_s <= 0:
        return None
    return run.units * run.rays_per_unit / run.window_s
