"""A whole run on the CPU, past the harness's look for a card: a small
Llama-shaped model behind the port's HTTP server, the load generator in
its child process, the window, the drain after it and the reference.
Sound, the run is ``correct``; with the timed path broken underneath (a token altered where
it is produced, a decode step that leaves the caches unchanged, half the
batch left out) it is not.  An architecture registered from a test, with
no file under ``portbench/``, reaches the line's counters and ``mfu``."""

import hashlib
import json
import sys
import types
from pathlib import Path

import pytest

from portbench import check_line, run
from portbench.archs import llama
from portbench.window import Window

ROOT = Path(__file__).resolve().parents[2]
DEEPSEEK = json.loads((ROOT / "portbench" / "configs" /
                       "deepseek-llm-7b-base.json").read_text())
TINY = {"name": "tiny", "vocab_size": 512, "hidden_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 128,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 96, "model": "llama",
        "reference": "llama",
        "engine": {"residency": "in_memory", "slots": 4, "chunk_size": 16,
                   "row2col": "auto", "cache_layout": "auto",
                   "precision": "f32", "kv_page_tokens": 16,
                   "max_tokens_cap": 40},
        "checks": {"max_logit_gap": DEEPSEEK["checks"]["max_logit_gap"],
                   "min_served_positions": 20}}
TRAFFIC = {"clients": 4, "lead_in_s": 0.5, "first_token_wait_s": 10,
           "drain_s": 3, "rounds": 40, "system_prompts": {"count": 2, "tokens": 32},
           "prompt_tokens": [8, 8, 16, 24], "output_tokens": [4, 8, 20, 36]}
E2E = [("output_tokens_per_s", "tokens/s"), ("ttft_p50_ms", "ms"),
       ("setup_s", "s")]


def token_altered(system):
    inner = system.server.batcher.decode_fn

    def decode(seq_ids, last):
        out = inner(seq_ids, last)
        out[0] = (out[0] + 1) % system.shapes.vocab
        return out
    system.server.batcher.decode_fn = decode


def state_unchanged(system):
    dec = system.decoder
    dec.pool.scatter_rows = lambda *a, **k: None
    inner = system.server.batcher.decode_fn

    def decode(seq_ids, last):
        dec._view_key = None        # every tick reads the pool again
        return inner(seq_ids, last)
    system.server.batcher.decode_fn = decode


def half_batch(system):
    inner = system.server.batcher.decode_fn

    def decode(seq_ids, last):
        keep = max(1, len(seq_ids) // 2)
        out = inner(seq_ids[:keep], last[:keep])
        return out + list(last[keep:])
    system.server.batcher.decode_fn = decode


@pytest.mark.parametrize("fault", [None, token_altered, state_unchanged,
                                   half_batch],
                         ids=["sound", "token_altered", "state_unchanged",
                              "half_batch"])
def test_run_on_cpu(fault, tmp_path):
    traffic = tmp_path / "tiny.json"
    traffic.write_text(json.dumps(TRAFFIC))
    line = run.run_cell(TINY, str(traffic), 2_718_281_828_459, 2.5, False,
                        E2E, device="cpu", plant=fault,
                        control=fault is None)
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"
    if fault is None:
        # the control is judged by the same verdict, beside the program's
        assert set(line["control"]) == {"checks", "correct",
                                        "positions_over_limit"}
        assert set(line["control"]["checks"]) == set(line["checks"])
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {n for n, _ in E2E}
    if fault is None:
        assert line["checks"]["max_logit_gap"]["value"] < 1e-5
        bench = {"workloads": [{"name": "tiny", "chips": 1}],
                 "end_to_end": [{"name": n, "unit": u} for n, u in E2E],
                 "per_layer": []}
        assert check_line.problems(json.dumps(line), bench, "tiny", False,
                                   platform="cpu") == []


def _files(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_architecture_needs_no_edit(monkeypatch, tmp_path):
    """``toy`` is Llama with a counter and a ``decode_flops`` of its own,
    found by the name in the configuration: the line carries its counter
    (the harness takes it at both edges of the window) and ``mfu`` comes
    from its counts, with no file under ``portbench/`` added or changed."""
    toy = types.ModuleType("portbench.archs.toy")
    for name in ("shapes", "block_names", "block_spec", "build",
                 "prefill_flops", "decode_least_s", "prefill_least_s"):
        setattr(toy, name, getattr(llama, name))
    snapshots = []

    def counters(engine):
        snapshots.append(type(engine).__name__)
        return {"toy_snapshots": len(snapshots)}

    def decode_flops(s, rows, keys):
        return 3.0 * llama.decode_flops(s, rows, keys)
    toy.counters, toy.decode_flops = counters, decode_flops
    monkeypatch.setitem(sys.modules, "portbench.archs.toy", toy)
    windows = []

    def window(**kw):
        windows.append(Window(**kw))
        return windows[-1]
    monkeypatch.setattr(run, "Window", window)

    bench_dir = ROOT / "portbench"
    before = _files(bench_dir)
    traffic = tmp_path / "tiny.json"
    traffic.write_text(json.dumps(TRAFFIC))
    line = run.run_cell(dict(TINY, model="toy"), str(traffic), 3_141_592_653,
                        2.5, False, E2E + [("mfu", "%")], device="cpu")
    after = _files(bench_dir)
    assert after == before, sorted(set(after.items()) ^ set(before.items()))
    assert not (bench_dir / "archs" / "toy.py").exists()
    assert line["correct"] is True, line["checks"]
    assert line["counters"]["toy_snapshots"] == 1, line["counters"]
    assert snapshots == ["RelationalEngine"] * 2, snapshots
    w, = windows
    assert w.arch is toy and w.decodes

    def mfu(decode):
        flops = (sum(decode(w.shapes, rows, keys)
                     for _, _, rows, keys in w.decodes)
                 + sum(llama.prefill_flops(w.shapes, ctx, cached)
                       for _, _, ctx, cached in w.prefills))
        return 100.0 * flops / (w.gate_s * w.peaks["f32_flops_per_s"])
    got = line["metrics"]["mfu"]["value"]
    assert got == pytest.approx(mfu(decode_flops), rel=1e-12)
    assert got > mfu(llama.decode_flops)
