"""field_idle_pct.train (%): the device-only pass's idle whose gap began
while the deepest port span open was a ``field.*`` span, in a train cell,
as % of the pass's window (``program_spans``: the port's spans laid on
the device trace's clock)."""

from nerfbench import program_spans


def read(run):
    return program_spans.idle_pct(run, "train", "field")
