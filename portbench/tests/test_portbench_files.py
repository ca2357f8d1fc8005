"""The benchmark's files: every cell finds its configuration, traffic,
architecture and metric readers by name, ``BENCHMARK.json`` keeps to the
contract's form, nothing under ``portbench/`` imports the JAX package or
JAX, and only the Llama architecture and its reference know Llama."""

import ast
import json
import re
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head",
               "expansion", "experts_per_tok")


def _cells():
    return [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", _cells())
def test_cell_finds_its_files(cell):
    c = next(w for w in BENCH["workloads"] if w["name"] == cell)
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert (BENCH_DIR / "traffic" / f"{c['traffic']}.json").is_file()
    assert (BENCH_DIR / "references" / f"{cfg['reference']}.py").is_file()
    assert (BENCH_DIR / "archs" / f"{cfg['model']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if "workloads" not in m or cell in m["workloads"]:
            assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    assert c["chips"] == 1 and 1 <= len(c["why"]) <= 200


def test_names_units_and_sources():
    e2e, pl = BENCH["end_to_end"], BENCH["per_layer"]
    cells = set(_cells())
    names = [m["name"] for m in e2e + pl] + list(cells) \
        + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in e2e)
    e2e_names = {m["name"] for m in e2e}
    for m in pl:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e_names and m["source"] in SOURCES
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + pl:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_config_reduced_lists_no_width(conf):
    c = next(x for x in BENCH["configs"] if x["name"] == conf)
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    for key in c["reduced"]:
        assert not key.endswith(("_dim", "_rank")), key
        assert not any(w in key for w in WIDTH_WORDS), key


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources():
    return sorted(p for p in BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_or_jax_package(path):
    """Top-level module names compared whole: ``repro_torch`` is the
    port, ``repro`` the JAX package."""
    top = {m.split(".")[0] for m in _imports(path)}
    assert not top & {"jax", "jaxlib", "flax", "repro"}, path
    assert "benchmarks/" not in path.read_text() or path.name.startswith(
        "test_portbench_files"), path


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "references")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    top = {m.split(".")[0] for m in _imports(path)}
    assert top <= {"__future__", "contextlib", "typing", "math", "torch",
                   "numpy", "portbench"}, top
    assert not any(m.startswith(("portbench.system", "portbench.run"))
                   for m in _imports(path))


# the Llama graph's tensors, as archs/llama.py names them
LLAMA_TENSOR = re.compile(r"Q_weights|K_weights|V_weights|o_weights|GLU_W[123]"
                          r"|Attention_Norm|FFN_Norm|Final_Norm|lm_head")
LLAMA_HOME = {Path("archs/llama.py"), Path("references/llama.py")}


def _outside_llama():
    return [p for p in _sources()
            if p.relative_to(BENCH_DIR) not in LLAMA_HOME
            and "tests" not in p.relative_to(BENCH_DIR).parts]


@pytest.mark.parametrize("path", _outside_llama(),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_only_the_llama_architecture_knows_llama(path):
    """The harness reaches the model through the configuration's
    ``archs/<model>.py`` alone: no other module imports the Llama graph,
    ``LlamaSpec`` or the Llama architecture, or names a Llama tensor."""
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Name):
            names = [node.id]
        elif isinstance(node, ast.Attribute):
            names = [node.attr]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not LLAMA_TENSOR.search(node.value), (path, node.value)
        for n in names:
            assert "llama_graph" not in n and "LlamaSpec" not in n, (path, n)
            assert n != "portbench.archs.llama", (path, n)
