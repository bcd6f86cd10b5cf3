"""step_idle_pct.train (%): the device-only pass's idle whose gap began
inside the port's ``train.step`` and outside any ``field.*`` span, as %
of the pass's window (``program_spans``)."""

from nerfbench import program_spans


def read(run):
    return program_spans.idle_pct(run, "train", "unit")
