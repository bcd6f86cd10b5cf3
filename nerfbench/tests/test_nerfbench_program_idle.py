"""``program_spans`` on a synthetic device trace and port store: the clock
base recovered from the pass with spans, known gaps named by the known
layer, a failed pairing read as None, the parts adding up to the pass's
idle, and the deepest span open at a time."""

import pytest

from nerfbench import program_spans
from nerfbench.trace import DeviceOp, Trace

BASE = 1_790_000_000_000_000_000  # ns: the port's clock less the trace's
DELAY = 3_000  # ns from a benchmark span's start to the port unit's


def op(a, b):
    return DeviceOp("k", "kernel", a * 1e-6, b * 1e-6, frozenset())


def device_pass():
    """A window [0, 100] us; busy [0, 10], [15, 40], [50, 52], [60, 95],
    [99, 100]: gaps at 10 (5 us), 40 (10), 52 (8), 95 (4)."""
    ops = [op(0, 10), op(15, 30), op(25, 40), op(50, 52), op(60, 95), op(99, 100)]
    return Trace((0.0, 100e-6), ops, [], None, 0)


def span_pass(starts_us, name="step"):
    spans = [(name, 1, a * 1e-6, (a + 50) * 1e-6) for a in starts_us]
    return Trace((starts_us[0] * 1e-6, (starts_us[-1] + 60) * 1e-6), [], spans, 1, 0)


def rec(i, name, parent, start_us, end_us, tid=1, base=BASE):
    return {"name": name, "id": i, "parent": parent, "unit": None, "tid": tid,
            "start": base + round(start_us * 1000), "end": base + round(end_us * 1000)}


def store(base=BASE, delay=DELAY):
    """The device-only pass's spans (one step from 5 to 90 us), then the
    span pass's units, each ``delay`` after its benchmark span."""
    first = [
        rec(1, "train.step", None, 5, 90, base=base),
        rec(2, "train.backward", 1, 30, 70, base=base),
        rec(3, "field.color_mlp.bwd", 2, 35, 45, tid=2, base=base),  # the autograd engine's thread
        rec(4, "train.adam", 1, 50, 56, base=base),
    ]
    second = [rec(10 + i, "train.step", None, a + delay * 1e-3, a + 40, base=base)
              for i, a in enumerate((1000, 1200, 1400, 1600))]
    return first + second


def test_known_gaps_go_to_the_known_layer():
    parts = program_spans.split_idle(device_pass(), span_pass([1000, 1200, 1400, 1600]), store(), "train")
    # gap at 10 in the step, outside any field span; 40 in the autograd
    # thread's color_mlp.bwd (deeper than train.backward); 52 in train.adam;
    # 95 after the step
    assert parts["field"] == pytest.approx(10e-6)
    assert parts["unit"] == pytest.approx(5e-6 + 8e-6)
    assert parts["outside"] == pytest.approx(4e-6)
    assert parts["by_span"] == pytest.approx({"train.step": 5e-6, "field.color_mlp.bwd": 10e-6, "train.adam": 8e-6,
                                              "-": 4e-6})
    assert parts["pairs"] == 4 and parts["spread"] == 0.0


def test_parts_add_up_to_the_idle():
    trace = device_pass()
    parts = program_spans.split_idle(trace, span_pass([1000, 1200, 1400, 1600]), store(), "train")
    assert parts["field"] + parts["unit"] + parts["outside"] == pytest.approx(trace.window_s - trace.busy_s())


def test_base_is_the_median_start_difference():
    base, spread, rng, pairs = program_spans.offset(span_pass([1000, 1200, 1400, 1600]), store(), "train")
    assert base == BASE + DELAY and pairs == 4 and rng == 0.0


def test_a_failed_pairing_reads_none(capsys):
    # no benchmark spans of the unit
    assert program_spans.split_idle(device_pass(), span_pass([1000, 1200], name="draw"), store(), "train") is None
    # more benchmark spans than port units
    assert program_spans.offset(span_pass([1000, 1200, 1400, 1600, 1800]), store(), "train") is None
    # the differences spread past the limit
    jittered = store()
    jittered[-1]["start"] += 200_000
    jittered[-2]["start"] += 150_000
    assert program_spans.offset(span_pass([1000, 1200, 1400, 1600]), jittered, "train") is None
    err = capsys.readouterr().err
    assert err.count("program_spans:") == 3 and "spread" in err


def test_render_pairs_chunks():
    """A render cell pairs each ``nb:chunk`` with its chunk's first port
    span, ``sample.coarse``."""
    # stamped DELAY later than the trace's clock, as the base recovered says
    recs = [rec(1, "render.frame", None, 5, 99), rec(2, "render.chunk", 1, 6, 45), rec(3, "field.forward", 2, 8, 20),
            rec(4, "render.gather", 1, 90, 99)]
    recs += [rec(10, "render.frame", None, 990, 1900)]
    for i, a in enumerate((1000, 1200, 1400)):
        recs += [rec(11 + 2 * i, "render.chunk", 10, a - 20, a + 100),
                 rec(12 + 2 * i, "sample.coarse", 11 + 2 * i, a + DELAY * 1e-3, a + 10)]
    recs += [rec(30, "sample.coarse", None, 1500, 1510)]  # not inside a chunk
    assert program_spans.offset(span_pass([1000, 1200, 1400], name="chunk"), recs, "render")[0] == BASE + DELAY
    parts = program_spans.split_idle(device_pass(), span_pass([1000, 1200, 1400], name="chunk"), recs, "render")
    # gap at 10 in field.forward; 40 in the frame outside its chunk; 52 the
    # frame; 95 in render.gather
    assert parts["field"] == pytest.approx(5e-6)
    assert parts["unit"] == pytest.approx(10e-6 + 8e-6 + 4e-6)
    assert parts["outside"] == pytest.approx(0.0, abs=1e-15)


def test_the_deepest_open_span_follows_parents_across_threads():
    spans = [dict(id=1, parent=None, name="train.step", start=0, end=100),
             dict(id=2, parent=1, name="train.backward", start=10, end=80),
             dict(id=3, parent=2, name="field.encode_bwd", start=30, end=40),  # another thread
             dict(id=4, parent=1, name="train.adam", start=80, end=95)]
    index = program_spans.Spans(spans)
    assert [s["name"] if s else None for s in map(index.deepest, (5, 20, 30, 39, 40, 85, 100))] == [
        "train.step", "train.backward", "field.encode_bwd", "field.encode_bwd", "train.backward", "train.adam", None]
    assert [s["name"] for s in index.ancestors(spans[2])] == ["field.encode_bwd", "train.backward", "train.step"]
