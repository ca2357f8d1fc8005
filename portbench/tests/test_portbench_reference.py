"""The plain reference against a hand-written float64 loop, and against
the port's engine on the CPU; the TF32 rounding of the control."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import checks
from portbench.archs import llama
from portbench.model import SeededWeights, block_weights
from portbench.references import llama as ref

TINY = dict(vocab_size=7, hidden_size=4, num_hidden_layers=1,
            num_attention_heads=2, num_key_value_heads=1,
            intermediate_size=3, rope_theta=10000.0, rms_norm_eps=1e-5)


def _loop_logits(s: llama.Shapes, seed: int, toks):
    """Llama by hand, one scalar at a time, in float64."""
    w = {k: v.double().numpy() for b in ("embed", "layer0", "head")
         for k, v in block_weights(llama, s, seed, b, "cpu").items()}
    T, H, dh, g = len(toks), s.heads, s.head_dim, s.heads // s.kv_heads

    def norm(x, wt):
        r = 1 / math.sqrt(sum(v * v for v in x) / len(x) + s.eps)
        return [x[i] * r * wt[i] for i in range(len(x))]

    def rope(vec, t):
        half = dh // 2
        out = list(vec)
        for i in range(half):
            ang = t / s.rope_theta ** (i / half)
            a, b = vec[i], vec[i + half]
            out[i] = a * math.cos(ang) - b * math.sin(ang)
            out[i + half] = a * math.sin(ang) + b * math.cos(ang)
        return out

    def mv(m, x):
        return [sum(m[r][c] * x[c] for c in range(len(x)))
                for r in range(len(m))]

    h = [list(w["vocabulary"][t]) for t in toks]
    xs = [norm(h[t], w["Attention_Norm_L0"]) for t in range(T)]
    q = [[rope(mv(w["Q_weights_L0"][hh], xs[t]), t) for hh in range(H)]
         for t in range(T)]
    k = [[rope(mv(w["K_weights_L0"][hh], xs[t]), t)
          for hh in range(s.kv_heads)] for t in range(T)]
    v = [[mv(w["V_weights_L0"][hh], xs[t]) for hh in range(s.kv_heads)]
         for t in range(T)]
    for t in range(T):
        att = []
        for hh in range(H):
            sc = [sum(q[t][hh][i] * k[u][hh // g][i] for i in range(dh))
                  / math.sqrt(dh) for u in range(t + 1)]
            m = max(sc)
            e = [math.exp(x - m) for x in sc]
            p = [x / sum(e) for x in e]
            att += [sum(p[u] * v[u][hh // g][i] for u in range(t + 1))
                    for i in range(dh)]
        h[t] = [a + b for a, b in zip(h[t], mv(w["o_weights_L0"], att))]
        x = norm(h[t], w["FFN_Norm_L0"])
        a, b = mv(w["GLU_W1_L0"], x), mv(w["GLU_W3_L0"], x)
        m = [a[i] / (1 + math.exp(-a[i])) * b[i] for i in range(len(a))]
        h[t] = [u + z for u, z in zip(h[t], mv(w["GLU_W2_L0"], m))]
    return np.array([mv(w["lm_head"], norm(h[t], w["Final_Norm"]))
                     for t in range(T)])


def test_reference_matches_hand_loop():
    s = llama.shapes(TINY)
    toks = [1, 4, 2, 6, 6, 0]
    got = ref.logits(s, 3, [toks], [0], "cpu")[0].double().numpy()
    np.testing.assert_allclose(got, _loop_logits(s, 3, toks), atol=2e-6)
    # first > 0 keeps the later positions only
    tail = ref.logits(s, 3, [toks], [4], "cpu")[0]
    np.testing.assert_allclose(tail.numpy(), got[4:], atol=1e-6)


def test_round_tf32():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11 + 2 ** -13,
                      1 + 2 ** -12, -3.0e-5])
    r = ref._round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1 + 2 ** -10
    assert r[2] == 1 + 2 ** -10          # rounds up past the half ulp
    assert r[3] == 1.0                   # rounds down below it
    bits = r.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0


def test_reference_matches_port_engine():
    src = Path(__file__).resolve().parents[2] / "src"
    sys.path.insert(0, str(src))
    from repro_torch.core.llama_graph import LlamaSpec
    from repro_torch.serving.engine import RelationalEngine
    cfg = dict(TINY, vocab_size=320, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=96)
    s = llama.shapes(cfg)
    spec = LlamaSpec(vocab=s.vocab, d_model=s.d, n_layers=s.layers,
                     n_heads=s.heads, n_kv=s.kv_heads, d_ff=s.ff,
                     rope_theta=s.rope_theta, eps=s.eps)
    eng = RelationalEngine(spec, SeededWeights(llama, s, 11, "cpu"),
                           chunk_size=16, max_len=48, device="cpu")
    prompt = np.random.default_rng(1).integers(0, s.vocab, 24).tolist()
    toks = eng.generate(prompt, 10).tokens
    lg = ref.logits(s, 11, [prompt + toks[:-1]], [len(prompt) - 1], "cpu")
    assert checks._gaps(lg, [torch.tensor(toks)]) < 1e-5


CONF = Path(__file__).resolve().parents[1] / "configs"
# the configurations this file's Llama-shaped SMALL model stands for
LLAMA_CONFS = [p.stem for p in sorted(CONF.glob("*.json"))
               if json.loads(p.read_text())["model"] == "llama"]
SMALL = dict(TINY, vocab_size=4096, hidden_size=256, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=512)


@pytest.mark.parametrize("conf", LLAMA_CONFS)
def test_control_fails_the_limit(conf):
    """The control, the reference in TF32 (rounded operands on the CPU),
    read at 2048 positions of a small model of the configuration's
    family: its widest gap exceeds the configuration's limit, where the
    float32 reference's own is 0."""
    cfg = json.loads((CONF / f"{conf}.json").read_text())
    s = llama.shapes(SMALL)
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, s.vocab, (128,), generator=g).tolist()
            for _ in range(16)]
    f32 = ref.logits(s, 5, seqs, [0] * 16, "cpu", "f32")
    low = ref.logits(s, 5, seqs, [0] * 16, "cpu", "tf32")
    assert checks._gaps(f32, [x.argmax(-1) for x in f32]) == 0.0
    assert checks._gaps(f32, [x.argmax(-1) for x in low]) > \
        cfg["checks"]["max_logit_gap"]


def _greedy_records(s: llama.Shapes, seed: int, n: int, prompt: int,
                    out: int):
    """``n`` streams as the load generator records them, each a random
    prompt and ``out`` tokens decoded greedily by the float32 reference."""
    g = torch.Generator().manual_seed(seed)
    seqs = [torch.randint(0, s.vocab, (prompt,), generator=g).tolist()
            for _ in range(n)]
    for _ in range(out):
        lg = ref.logits(s, seed, seqs, [len(q) - 1 for q in seqs], "cpu")
        for q, x in zip(seqs, lg):
            q.append(int(x[-1].argmax()))
    return [{"prompt": q[:prompt], "tokens": q[prompt:], "max_tokens": out,
             "idx": list(range(out)), "status": 200, "error": None,
             "done": True} for q in seqs]


@pytest.mark.parametrize("conf", LLAMA_CONFS)
def test_judge_finds_the_control_not_correct(conf):
    """The verdict that decides ``correct``, on greedy streams of a small
    model of the configuration's family as many positions long as the
    configuration asks: the program's tokens pass it, the control (the
    reference in TF32 in the program's place) does not, and a token
    altered fails it too."""
    cfg = json.loads((CONF / f"{conf}.json").read_text())
    small = dict(SMALL, model=cfg["model"], reference=cfg["reference"],
                 checks=cfg["checks"])
    s = llama.shapes(small)
    need = cfg["checks"]["min_served_positions"]
    recs = _greedy_records(s, 5, 32, 64, -(-need // 32))
    out = checks.judge(small, 5, recs, "cpu", control=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] == 0.0
    assert out["checks"]["min_served_positions"]["value"] >= need
    assert out["control"]["correct"] is False, out["control"]
    assert out["control"]["checks"]["max_logit_gap"]["value"] > \
        cfg["checks"]["max_logit_gap"]
    recs[3]["tokens"][5] = (recs[3]["tokens"][5] + 1) % s.vocab
    assert checks.judge(small, 5, recs, "cpu")["correct"] is False
