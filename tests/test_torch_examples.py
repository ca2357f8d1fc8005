"""The port's twins of the reference's examples, on the CPU.

- ``examples/sql_dump_torch.py`` writes the same SQL artifact, byte for
  byte, as ``examples/sql_dump.py`` under each planner option.
- ``examples/serve_paged_torch.py --device cpu`` (Disk+mem residency under
  a quarter of the model's bytes, continuous batching) generates the
  reference driver's tokens for its five batched requests, unsharded and
  with two shards.
- ``examples/load_client_torch.py`` drives ``examples/serve_http_torch.py
  --device cpu`` and exits 0 (every stream's SSE chunks in order, none
  duplicated or dropped).
"""

import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
TIMEOUT_S = 300


def _run(argv, cwd):
    return subprocess.Popen([sys.executable] + [str(a) for a in argv],
                            cwd=cwd, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    out, _ = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, out[-4000:]
    return out


@pytest.mark.parametrize("opts", [
    [], ["--row2col", "auto"],
    ["--row2col", "col", "--cache-layout", "head_major"],
    ["--precision", "int8", "--chunk-size", "32"]],
    ids=["default", "row2col_auto", "col_head_major", "int8_chunk32"])
def test_sql_dump_matches_reference(opts, tmp_path):
    procs = [_run([EXAMPLES / script, "--out", tmp_path / f"{tag}.sql"]
                  + opts, tmp_path)
             for script, tag in (("sql_dump.py", "jax"),
                                 ("sql_dump_torch.py", "torch"))]
    for p in procs:
        _finish(p)
    want = (tmp_path / "jax.sql").read_text()
    assert (tmp_path / "torch.sql").read_text() == want
    assert "CREATE OR REPLACE VIEW" in want


def _tokens(out: str):
    """Each batched request's prompt length and generated tokens."""
    return re.findall(r"req(\d+): prompt=(\d+)t gen=(\[[^\]]*\])", out)


def test_serve_paged_matches_reference(tmp_path):
    procs = [_run([EXAMPLES / "serve_paged.py"], tmp_path)] + [
        _run([EXAMPLES / "serve_paged_torch.py", "--shards", shards,
              "--device", "cpu"], tmp_path) for shards in ("1", "2")]
    want, got, sharded = (_finish(p) for p in procs)
    assert len(_tokens(want)) == 5
    assert _tokens(got) == _tokens(want)
    assert _tokens(sharded) == _tokens(want)
    assert "served 5 requests" in got
    assert "shard workers (n=2)" in sharded


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_load_client_drives_the_port_server(tmp_path):
    port = _free_port()
    server = _run([EXAMPLES / "serve_http_torch.py", "--device", "cpu",
                   "--port", port], tmp_path)
    try:
        client = _run([EXAMPLES / "load_client_torch.py", "--port", port,
                       "--n", 6, "--concurrency", 3, "--max-tokens", 4,
                       "--shared-prefix-frac", 0.5, "--ready-s", 120,
                       "--scrape-metrics", tmp_path / "scrape.prom",
                       "--shutdown"], tmp_path)
        out = _finish(client)
        assert "requests: 6  ok: 6" in out, out
        assert "serving_prefills_total" in (tmp_path /
                                            "scrape.prom").read_text()
        deadline = time.monotonic() + 60
        while server.poll() is None and time.monotonic() < deadline:
            time.sleep(0.2)
        assert server.poll() == 0
    finally:
        if server.poll() is None:
            server.kill()
        server.communicate()
