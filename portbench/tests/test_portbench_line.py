"""The last-line assembler, fed a recorded window for each cell, prints
every metric the cell lists in both modes, with the contract's keys and
device fields; ``check_line`` finds no problem with it; the trace's
reduction merges overlapping device work and labels the idle gaps."""

import json
from pathlib import Path

import pytest

from portbench import check_line, counts, devtrace, run
from portbench.model import architecture
from portbench.window import Window

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NS = 1_000_000_000


def _window(cfg, trace: bool) -> Window:
    model = architecture(cfg)
    base = 10 * NS
    decodes = [(base + i * NS // 10, base + i * NS // 10 + 60_000_000, 16,
                16 * 700) for i in range(100)]
    prefills = [(base + i * NS, base + i * NS + 20_000_000, 600, 512)
                for i in range(8)]
    edges = {"open": {"decode_calls": 1000, "prefix_cached_tokens": 9000,
                      "pager_bytes_loaded": 5 * 10 ** 12},
             "close": {"decode_calls": 1100, "prefix_cached_tokens": 13096,
                       "pager_bytes_loaded": 5 * 10 ** 12 + 4 * 10 ** 11}}
    reqs = []
    for c in range(16):
        t = 99.0 + c * 0.1
        reqs.append({"client": c, "k": 0, "prompt": [1] * 600,
                     "max_tokens": 40, "sent": t,
                     "times": [t + 0.3 + 0.1 * i for i in range(40)],
                     "tokens": [2] * 40, "idx": list(range(40)),
                     "status": 200, "rid": f"cmpl-{c}", "done": True,
                     "error": None})
    dev = None
    if trace:
        events = [(a + 1_000_000, a + 30_000_000,
                   "void gemv_col_kernel<float, 4>(float const*)")
                  for a, *_ in decodes]
        events += [(a + 20_000_000, a + 50_000_000,
                    "Memcpy HtoD (Pinned -> Device)") for a, *_ in decodes]
        calls = [("decode", a, b) for a, b, *_ in decodes] + \
            [("prefill", a, b) for a, b, *_ in prefills]
        dev = devtrace.reduce(events, base, base + 10 * NS, calls)
    return Window(arch=model, shapes=model.shapes(cfg), peaks=counts.peaks(),
                  seconds=10.0, t_open=100.0, t_close=110.0, requests=reqs,
                  setup_s=61.5, prefills=prefills, decodes=decodes,
                  edges=edges, gate_s=10.0, device=dev)


CASES = [(c["name"], t) for c in BENCH["workloads"] for t in (0, 1)]


@pytest.mark.parametrize("cell,trace", CASES)
def test_every_listed_metric_is_printed(cell, trace):
    c = next(w for w in BENCH["workloads"] if w["name"] == cell)
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    metrics = run.cell_metrics(BENCH, cell, bool(trace))
    judged = {"correct": True, "checks": {
        "max_logit_gap": {"value": 1e-5, "limit": 1e-3},
        "min_served_positions": {"value": 640, "limit": 400},
        "broken_streams": {"value": 0, "limit": 0}}}
    line = run.assemble(_window(cfg, bool(trace)), metrics, judged, {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "memory_peak_bytes": 70 * 2 ** 30})
    text = json.dumps(line)
    assert check_line.problems(text, BENCH, cell, bool(trace)) == []
    assert [n for n, _ in metrics] == list(line["metrics"])
    for v in line["metrics"].values():
        assert v["value"] > 0
    if trace:
        assert line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) == 2
    m = line["metrics"]
    if not trace:
        assert m["setup_s"]["value"] == 61.5
        # 16 streams of 40 tokens, the first at 99.3 s, 0.1 s apart: those
        # from 100 s on fall inside the 10 s window starting at 100 s
        inside = sum(1 for c in range(16) for i in range(40)
                     if 100.0 <= (99.0 + c * 0.1) + 0.3 + 0.1 * i < 110.0)
        assert m["output_tokens_per_s"]["value"] == inside / 10.0


def test_check_line_flags_a_missing_metric():
    cell = BENCH["workloads"][0]["name"]
    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
            "device": {"platform": "gpu", "kind": "x", "count": 1,
                       "memory_peak_bytes": 1},
            "checks": {}}
    found = check_line.problems(json.dumps(line), BENCH, cell, False)
    assert any("lacks setup_s" in p for p in found)


def test_reduce_merges_and_labels():
    ev = [(0, 10, "a"), (5, 20, "b"), (40, 50, "a")]
    r = devtrace.reduce(ev, 0, 100, [("decode", 15, 45)])
    assert r["busy_s"] == pytest.approx(30 / 1e9)
    assert r["by_name"] == {"a": 20 / 1e9, "b": 15 / 1e9}
    gaps = dict(map(tuple, r["breakdown"]["idle_gaps"]))
    assert gaps["all gaps, host in decode"] == pytest.approx(20 / 1e9)
    assert gaps["all gaps, host between calls"] == pytest.approx(50 / 1e9)
