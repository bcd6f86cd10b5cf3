"""loop_idle_pct.render (%): the device-only pass's idle whose gap began
inside the port's ``render.frame`` and outside any ``field.*`` span, as %
of the pass's window (``program_spans``)."""

from nerfbench import program_spans


def read(run):
    return program_spans.idle_pct(run, "render", "unit")
