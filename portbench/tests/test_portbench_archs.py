"""The architecture seam: a configuration names its architecture, each
architecture module has the functions the harness calls, and the Llama
architecture draws the weights it drew before it had a module of its
own."""

import hashlib
from pathlib import Path

import pytest

from portbench.archs import llama
from portbench.model import SeededWeights, architecture

ARCHS = Path(__file__).resolve().parents[1] / "archs"
INTERFACE = ("shapes", "block_names", "block_spec", "build", "counters",
             "decode_flops", "prefill_flops", "decode_least_s",
             "prefill_least_s")
TINY = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5}


@pytest.mark.parametrize("name", [p.stem for p in sorted(ARCHS.glob("*.py"))])
def test_architecture_has_the_interface(name):
    mod = architecture({"model": name})
    for fn in INTERFACE:
        assert callable(getattr(mod, fn, None)), (name, fn)


def test_configuration_must_name_its_architecture():
    with pytest.raises(ValueError, match="names no architecture"):
        architecture({"name": "unnamed", **TINY})
    assert architecture(dict(TINY, model="llama")) is llama


def test_llama_weights_are_the_parents():
    """Every tensor's name, shape and bytes for one seed hash to what the
    harness drew before the architecture seam (the same digest of the
    seed and block, one ``randn`` a block, the same scales and order)."""
    h = hashlib.sha256()
    for name, t in SeededWeights(llama, llama.shapes(TINY), 2_718_281_828_459,
                                 "cpu").items():
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == \
        "176637ddca27b544a3182c1ded70e21c52280dc33fa84ffe8637e16c57790b85"
