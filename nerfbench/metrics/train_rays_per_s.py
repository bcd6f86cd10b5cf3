"""train_rays_per_s (rays/s): every ray trained in the window over the
window's length, steps back to back between one synchronize at each end."""


def read(run):
    if run.cell.job != "train" or run.window_s <= 0:
        return None
    return run.units * run.rays_per_unit / run.window_s
