"""device_idle_pct.render (%): 1 - (union of the device's kernel, copy and
fill intervals) / the traced window, in a render cell."""

from nerfbench.metrics._common import traced


def read(run):
    if not traced(run, "render"):
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
