"""Quickstart on the PyTorch/CUDA port: compile a small Llama to SQL and run
it both ways.

    python examples/quickstart_torch.py                  # on the CUDA card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

1. Builds the inference graph for a small Llama-family model.
2. Stage-1 maps every neural operator to relational functions; stage-2
   emits the DuckDB SQL script (printed, truncated).
3. Executes the same relational plan on the port's columnar executor and
   checks it against the port's dense forward (``repro_torch.models``) on
   the same weights — the two paths are the same model.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.bridge import (llama_params_to_tree,  # noqa: E402
                                     spec_to_config)
from repro_torch.core.graph import infer_shapes  # noqa: E402
from repro_torch.core.llama_graph import (LlamaSpec,  # noqa: E402
                                          build_prefill_graph,
                                          convert_weights,
                                          empty_cache_tables,
                                          init_llama_params, rope_freq_table,
                                          token_table)
from repro_torch.core.opmap import op_map  # noqa: E402
from repro_torch.core.passes import postoptimize, preoptimize  # noqa: E402
from repro_torch.core.pipeline import run_pipeline  # noqa: E402
from repro_torch.core.sqlgen import generate_sql  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402


def main(device: str) -> None:
    import torch
    spec = LlamaSpec(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv=2,
                     d_ff=128, rope_theta=10000.0)
    params = init_llama_params(spec, seed=0)
    prompt = np.asarray([11, 42, 7, 99, 3], np.int64)
    T = len(prompt)

    print("=== stage 0: neural graph ===")
    graph = build_prefill_graph(spec, T)
    infer_shapes(graph)
    stats = preoptimize(graph)
    print(f"nodes={len(graph.nodes)} preopt={stats}")

    print("\n=== stage 1: operator mapping (neural → relational) ===")
    pipe = op_map(graph, chunk_size=32)
    post = postoptimize(pipe)
    print(f"steps={len(pipe.steps)} relational nodes: "
          f"{post['rel_nodes_before']} → {post['rel_nodes_after']} (CTE fusion)")

    print("\n=== stage 2: SQL generation (DuckDB dialect) ===")
    sql = generate_sql(pipe, dialect="duckdb")
    print(sql[:1500])
    print(f"... [{len(sql)} chars total]")

    print(f"\n=== execute the relational plan on the port's executor "
          f"({device}) ===")
    env = convert_weights(params, chunk_size=32, device=device)
    env.update(empty_cache_tables(spec, cache_len=T, chunk_size=32,
                                  device=device))
    env["token_ids"] = token_table(prompt, device=device)
    env["freq_each_token"] = rope_freq_table(np.arange(T), spec.head_dim,
                                             spec.rope_theta, device=device)
    outs, _ = run_pipeline(pipe, env, scalars={"cache_position": 0})
    rel_logits = outs["logits"].cols["v"].reshape(T, -1)[:, : spec.vocab]
    rel_logits = rel_logits.cpu().numpy()

    print("=== the port's dense forward (same weights) ===")
    cfg = spec_to_config(spec)
    tree = llama_params_to_tree(params, spec, device=device)
    tokens = torch.from_numpy(prompt[None]).to(device)
    direct = tf.forward(tree, {"tokens": tokens}, cfg)[0].cpu().numpy()

    err = np.abs(rel_logits - direct).max()
    print(f"max |relational - direct| = {err:.2e}")
    if not err < 1e-3:
        raise SystemExit(f"the two paths differ by {err:.2e}")
    print("relational argmax:", rel_logits.argmax(-1).tolist())
    print("direct     argmax:", direct.argmax(-1).tolist())
    print("OK — the SQL pipeline and the dense model are the same function.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the tables, caches and the dense model run "
                         "(default: the CUDA card)")
    main(ap.parse_args().device)
