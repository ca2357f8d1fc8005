"""The port stands alone: no file of ``src/repro_torch/`` (the distributed,
launch and analysis modules included; nor the GPU smoke script, nor the
port's examples: the HTTP server, quickstart, training, paged serving, SQL
dump and load client)
imports JAX or anything of the JAX package ``repro``, and every module
imports without a GPU, ``nvcc`` or ``triton``."""

import ast
import importlib
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "examples" /
                                      "serve_http_torch.py",
                                      ROOT / "examples" /
                                      "quickstart_torch.py",
                                      ROOT / "examples" /
                                      "train_minilm_torch.py",
                                      ROOT / "examples" /
                                      "serve_paged_torch.py",
                                      ROOT / "examples" /
                                      "sql_dump_torch.py",
                                      ROOT / "examples" /
                                      "load_client_torch.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", [p for p in FILES if p.is_relative_to(PORT)],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_on_the_cpu(path):
    rel = path.relative_to(PORT.parent).with_suffix("")
    name = ".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)
    importlib.import_module(name)


def test_checker_catches_reference_imports():
    for src in ("import jax", "import jax.numpy as jnp",
                "from repro.core import executor", "import repro.kernels",
                "from jax.experimental import pallas"):
        names = [a.name for n in ast.walk(ast.parse(src))
                 if isinstance(n, ast.Import) for a in n.names] + [
            n.module for n in ast.walk(ast.parse(src))
            if isinstance(n, ast.ImportFrom)]
        assert any(_forbidden(n) for n in names), src
    assert not _forbidden("repro_torch.core.executor")


@pytest.mark.parametrize("rel", ["distributed/sharding.py",
                                 "distributed/collectives.py",
                                 "distributed/pipeline.py",
                                 "launch/mesh.py", "launch/specs.py",
                                 "launch/dryrun.py", "launch/hillclimb.py",
                                 "analysis/roofline.py"])
def test_distributed_modules_are_walked(rel):
    """The distributed and launch slices' modules are among the files
    checked above."""
    assert PORT / rel in FILES
