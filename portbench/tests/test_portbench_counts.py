"""The Llama architecture's work counts (``archs/llama.py``, over
``counts.py``) against counts made by hand at the configuration's
published shapes, and at Mistral-7B-v0.3's, whose grouped-query
attention the configuration does not have."""

import json
from pathlib import Path

import pytest

from portbench import counts
from portbench.archs import llama

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
PK = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12,
      "pcie_bytes_per_s": 64e9}


# published widths of https://huggingface.co/mistralai/Mistral-7B-v0.3
MISTRAL = {"vocab_size": 32768, "hidden_size": 4096,
           "num_hidden_layers": 32, "num_attention_heads": 32,
           "num_key_value_heads": 8, "intermediate_size": 14336,
           "rope_theta": 1e6, "rms_norm_eps": 1e-5}


def shapes(name):
    if name == "mistral-7b-v0.3":
        return llama.shapes(MISTRAL)
    return llama.shapes(json.loads((CONFIGS / f"{name}.json").read_text()))


# (config, projection weights, all parameters) by hand:
# Mistral-7B: 32 x (2 x 4096^2 + 2 x 1024 x 4096 + 3 x 14336 x 4096),
#   plus 2 x 32768 x 4096 embedding and head (7.248 B);
# DeepSeek-LLM-7B: 30 x (4 x 4096^2 + 3 x 11008 x 4096), plus
#   2 x 102400 x 4096 (6.910 B).
HAND = [("mistral-7b-v0.3", 6_979_321_856, 7_247_757_312),
        ("deepseek-llm-7b-base", 6_071_255_040, 6_910_115_840)]


@pytest.mark.parametrize("name,proj,total", HAND)
def test_parameters(name, proj, total):
    s = shapes(name)
    assert llama.projection_params(s) == proj
    assert proj + 2 * s.vocab * s.d == total


@pytest.mark.parametrize("name,proj,total", HAND)
def test_decode_and_prefill_flops(name, proj, total):
    s = shapes(name)
    head = 2 * s.vocab * 4096
    per_key = 4 * s.layers * 32 * 128
    # three sequences at positions 99, 500, 1000 read 100 + 501 + 1001 keys
    assert llama.decode_flops(s, 3, 1602) == \
        3 * (2 * proj + head) + per_key * 1602
    # 800 tokens, 768 of them cached: 32 new tokens at positions 768..799
    keys = sum(p + 1 for p in range(768, 800))
    assert llama.prefill_flops(s, 800, 768) == \
        32 * 2 * proj + head + per_key * keys
    # a cold prefill of 4 tokens reads 1 + 2 + 3 + 4 keys
    assert llama.prefill_flops(s, 4, 0) == \
        4 * 2 * proj + head + per_key * 10


@pytest.mark.parametrize("name,proj,total", HAND)
def test_least_time(name, proj, total):
    s = shapes(name)
    mats = [(32 * 128, 4096), (s.kv_heads * 128, 4096),
            (s.kv_heads * 128, 4096), (4096, 4096), (s.ff, 4096),
            (s.ff, 4096), (4096, s.ff)]

    def least(m, n, k):
        return max(2 * m * n * k / 67e12, 4 * (n * k + m * k + m * n) / 3.35e12)

    for rows in (1, 16, 256):
        hand = s.layers * sum(least(rows, n, k) for n, k in mats) \
            + least(rows, s.vocab, 4096)
        assert llama.decode_least_s(s, rows, PK) == pytest.approx(hand,
                                                                   rel=1e-12)
    # a decode tick at 16 rows is bound by its bytes: every f32 weight read
    # once, (projections + head) x 4 B over 3.35 TB/s, plus the rows' bytes
    tick = llama.decode_least_s(s, 16, PK)
    assert tick > 4 * (proj + s.vocab * 4096) / 3.35e12
    # a 256-token prefill's projections are bound by their FLOPs
    pre = llama.prefill_least_s(s, 1024, 768, PK)
    assert pre == pytest.approx(
        s.layers * sum(least(256, n, k) for n, k in mats)
        + least(1, s.vocab, 4096), rel=1e-12)
    assert least(256, s.ff, 4096) == 2 * 256 * s.ff * 4096 / 67e12


def test_peaks_file():
    pk = counts.peaks()
    assert pk == PK
