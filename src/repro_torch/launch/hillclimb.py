"""§Perf hillclimb driver: run tagged variants of the three chosen cells
through the port's dry-run and append the roofline rows to
build/hillclimb.jsonl.

Cells (chosen from the reference's §Roofline baseline table):
  A qwen3-14b  × train_4k   — worst MODEL/HLO among trains (0.16): redundant
                              compute around the model-sharded vocab
  B olmoe-1b-7b × prefill_32k — the only collective-bound cell: MoE combine
                              gathers the sharded expert buffer
  C deepseek-v3-671b × decode_32k — most representative of the paper's
                              technique (MLA compressed KV-cache tables);
                              baseline can't fit weights (TP-16 only)

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [TAG_PREFIX ...]
        [--device cpu]
"""

import json
import os
import sys

from repro_torch.launch import dryrun as dr
from repro_torch.launch.dryrun import run_cell

EXPERIMENTS = [
    # ---- Cell A ------------------------------------------------------------
    dict(arch="qwen3-14b", shape="train_4k",
         tag="A1_ce_onehot", cfg_overrides={"ce_impl": "onehot"}),
    dict(arch="qwen3-14b", shape="train_4k",
         tag="A2_ce_onehot+embed_tp",
         cfg_overrides={"ce_impl": "onehot"},
         rule_overrides={"embed/embedding": (None, "model")}),
    dict(arch="qwen3-14b", shape="train_4k",
         tag="A3_seq_parallel",
         rules_patch={"seq": ("model",)}),
    dict(arch="qwen3-14b", shape="train_4k",
         tag="A4_seq_parallel+ce_onehot",
         cfg_overrides={"ce_impl": "onehot"},
         rules_patch={"seq": ("model",)}),
    dict(arch="qwen3-14b", shape="train_4k",
         tag="A5_seq_par+no_remat",
         cfg_overrides={"remat": "none"},
         rules_patch={"seq": ("model",)}),
    # ---- Cell B ------------------------------------------------------------
    dict(arch="olmoe-1b-7b", shape="prefill_32k",
         tag="B1_ep_local", cfg_overrides={"moe_impl": "ep_local"}),
    dict(arch="olmoe-1b-7b", shape="prefill_32k",
         tag="B2_ep_local+ce",  # ce irrelevant at prefill; control run
         cfg_overrides={"moe_impl": "ep_local", "ce_impl": "onehot"}),
    dict(arch="olmoe-1b-7b", shape="prefill_32k",
         tag="B3_ep_local+seq_par",
         cfg_overrides={"moe_impl": "ep_local"},
         rules_patch={"seq": ("model",)}),
    dict(arch="deepseek-v3-671b", shape="prefill_32k",
         tag="B4_deepseek_ep_local",
         cfg_overrides={"moe_impl": "ep_local"}),
    # ---- Cell C ------------------------------------------------------------
    dict(arch="deepseek-v3-671b", shape="decode_32k",
         tag="C1_ep_all_chips",
         rules_patch={"expert": ("data", "model")}),
    dict(arch="deepseek-v3-671b", shape="decode_32k",
         tag="C2_ep_all+weights_2d",
         rules_patch={"expert": ("data", "model"),
                      "embed_fsdp": ("data",)}),
    dict(arch="deepseek-v3-671b", shape="decode_32k",
         tag="C3_ep_all+kv_seq",
         rules_patch={"expert": ("data", "model")},
         kv_seq={"axes": ("model",)}),
]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    only = argv or None
    out = "build/hillclimb.jsonl"
    os.makedirs("build", exist_ok=True)
    with open(out, "a") as f:
        for ex in EXPERIMENTS:
            if only and not any(ex["tag"].startswith(t) for t in only):
                continue
            dr.KV_SEQ_RULE.clear()
            dr.KV_SEQ_RULE.update(ex.get("kv_seq") or {})
            rec = run_cell(ex["arch"], ex["shape"], multi_pod=False,
                           extra_tag=ex["tag"],
                           cfg_overrides=ex.get("cfg_overrides"),
                           rule_overrides=ex.get("rule_overrides"),
                           rules_patch=ex.get("rules_patch"),
                           device_type=device)
            f.write(json.dumps(rec) + "\n")
            f.flush()


if __name__ == "__main__":
    main()
