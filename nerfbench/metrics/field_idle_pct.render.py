"""field_idle_pct.render (%): the device-only pass's idle whose gap began
while the deepest port span open was a ``field.*`` span, in a render cell,
as % of the pass's window (``program_spans``)."""

from nerfbench import program_spans


def read(run):
    return program_spans.idle_pct(run, "render", "field")
