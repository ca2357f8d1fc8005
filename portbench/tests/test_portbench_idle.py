"""Naming the card's idle time inside engine calls by the program's spans
(``idlespans``) on synthetic windows: exact shares, the innermost span
and a collection's precedence, other threads' spans ignored, ``0.0``
where a name holds no idle, the names of a call kind adding up to the
trace's idle gaps in that kind, the window's spans taken from the flight
ring (and a ring that dropped some refused), and the three readers."""

import dataclasses

import pytest

from portbench import devtrace, idlespans
from portbench.window import reader

SCHED, PREFETCH, HTTP = 11, 22, 33
BUSY = [(0, 10), (30, 40), (60, 100)]
CALLS = [("decode", 5, 50), ("prefill", 55, 70)]
SPANS = [
    (5, 20, "step", SCHED), (12, 18, "op", SCHED),
    (15, 17, "gc", HTTP),                  # any thread's collection
    (21, 28, "pager", SCHED),              # the miss path
    (41, 44, "pager", PREFETCH),           # the prefetch thread: no name
    (44, 50, "decoder", SCHED), (45, 49, "decoder", SCHED),
    (56, 58, "plan", SCHED),               # another category: unnamed
]


def _pieces(spans=SPANS, busy=BUSY):
    idle = idlespans.idle_intervals(busy, 0, 100)
    return idlespans.name_idle(idle, CALLS, spans, SCHED)


def test_idle_intervals_complement_the_busy_ones():
    assert idlespans.idle_intervals(BUSY, 0, 100) == [(10, 30), (40, 60)]
    assert idlespans.idle_intervals([(0, 100)], 0, 100) == []
    assert idlespans.idle_intervals([(-5, 3), (90, 120)], 0, 100) == [
        (3, 90)]


def test_each_idle_instant_takes_the_innermost_span_or_gc():
    by = idlespans.idle_by_span(_pieces())
    # decode: 10-12 step, 12-15 op, 15-17 gc, 17-18 op, 18-20 step,
    # 20-21 none, 21-28 pager, 28-30 none | 40-44 none (prefetch's
    # pager span), 44-50 decoder; prefill: 55-60 none, 56-58 plan
    assert by["decode"] == pytest.approx({"dispatch": 8e-9, "pager": 7e-9,
                                          "decoder": 6e-9, "gc": 2e-9,
                                          "unnamed": 7e-9})
    assert by["prefill"] == pytest.approx(
        dict.fromkeys(idlespans.NAMES, 0.0) | {"unnamed": 5e-9})


def test_shares_are_exact_and_zero_without_idle():
    pieces = _pieces()
    window_s = 100e-9
    got = {n: idlespans.share(pieces, n, window_s)
           for n in idlespans.NAMES}
    assert got == pytest.approx({"dispatch": 8.0, "pager": 7.0,
                                 "decoder": 6.0, "gc": 2.0,
                                 "unnamed": 12.0})
    assert sum(got.values()) == pytest.approx(35.0)
    busy = _pieces(busy=[(0, 100)])
    assert busy == []
    assert idlespans.share(busy, "pager", window_s) == 0.0
    assert idlespans.share(None, "pager", window_s) is None


def test_a_collection_overrides_every_span():
    spans = SPANS + [(5, 50, "gc", SCHED)]
    by = idlespans.idle_by_span(_pieces(spans))
    assert by["decode"]["gc"] == pytest.approx(30e-9)
    assert by["decode"]["dispatch"] == 0.0


def test_other_threads_spans_name_nothing():
    spans = [(5, 50, "step", PREFETCH), (5, 50, "op", HTTP)]
    by = idlespans.idle_by_span(_pieces(spans))
    assert by["decode"]["unnamed"] == pytest.approx(30e-9)
    assert by["decode"]["dispatch"] == 0.0


def test_names_add_up_to_the_traces_gaps_in_each_call_kind():
    """Where no gap straddles a call's edge (the trace labels a gap by
    its middle), each call kind's names add up to its idle gaps."""
    calls = [("decode", 5, 35), ("prefill", 38, 65)]
    events = [(a, b, "k") for a, b in BUSY]
    dev = devtrace.reduce(events, 0, 100, calls)
    gaps = dict(map(tuple, dev["breakdown"]["idle_gaps"]))
    by = idlespans.idle_by_span(idlespans.name_idle(
        idlespans.idle_intervals(BUSY, 0, 100), calls, SPANS, SCHED))
    assert sum(by["decode"].values()) == pytest.approx(
        gaps["all gaps, host in decode"])
    assert sum(by["prefill"].values()) == pytest.approx(
        gaps["all gaps, host in prefill"])
    assert idlespans.gap_names([(10, 30), (40, 60), (95, 99)],
                               _pieces()) == ["dispatch", "unnamed", ""]


@dataclasses.dataclass
class _Tick:
    seq: int
    records: tuple


def test_window_spans_come_from_the_ring_whole():
    rec = ("s", "step", 2.0, 3.0, 0, SCHED, "kind", "bind")
    ticks = [_Tick(4, (rec,)), _Tick(5, (rec, rec)), _Tick(6, ())]
    spans = idlespans.window_spans(ticks, 1_000, 5)
    assert spans == [(3_000, 6_000, "step", SCHED)] * 2
    with pytest.raises(RuntimeError, match="dropped"):
        idlespans.window_spans(ticks[1:], 1_000, 4)


class _Window:
    device = {"window_s": 100e-9}


@pytest.mark.parametrize("name", ["dispatch", "pager", "decoder"])
def test_readers(name):
    w = _Window()
    read = reader(f"idle_{name}_share")
    assert read(w) is None
    w.idle_named = _pieces()
    assert read(w) == pytest.approx({"dispatch": 8.0, "pager": 7.0,
                                     "decoder": 6.0}[name])
    w.idle_named = []
    assert read(w) == 0.0
