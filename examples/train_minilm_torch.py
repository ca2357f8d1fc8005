"""End-to-end training on the PyTorch port: a ~100M-parameter LM for a few
hundred steps with checkpoint/restart fault tolerance.

    python examples/train_minilm_torch.py [--steps 300] [--tiny] \\
        [--device cuda|cpu] [--inject-failure STEP]

The counterpart of ``examples/train_minilm.py`` on ``repro_torch``: the
same deterministic data pipeline, AdamW with warmup+cosine, grad clipping,
async checkpoints, and the recovery driver (an injected failure mid-run
demonstrates restart-to-exact-state).  It runs on the card unless
``--device cpu`` is given.
"""

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.chunked import resolve_device  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training.fault_tolerance import (  # noqa: E402
    FaultConfig, run_with_recovery)
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402

MINI_100M = ModelConfig(
    name="minilm-100m", family="dense", n_layers=8, d_model=768, n_heads=12,
    n_kv=4, d_ff=2048, vocab=32768, rope_theta=10000.0,
    dtype="float32", param_dtype="float32", remat="none",
)
TINY = ModelConfig(
    name="minilm-tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv=2, d_ff=256, vocab=1024, rope_theta=10000.0,
    dtype="float32", param_dtype="float32", remat="none",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="CI-scale model instead of the 100M one")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="crash at this step once, to exercise recovery")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = TINY if args.tiny else MINI_100M
    seq = args.seq or (64 if args.tiny else 256)
    batch = args.batch or (8 if args.tiny else 16)

    n_params = cfg.param_count()
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, "
          f"seq={seq} batch={batch} steps={args.steps} device={device}")

    opt = AdamW(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(cfg, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch)

    def init_state():
        p = tf.init_params(cfg, 0, device=device)
        return p, opt.init(p)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}

    logged = _Logged(step)
    ckpt_dir = tempfile.mkdtemp(prefix="minilm_ckpt_")
    fail_at = {args.inject_failure: 0} if args.inject_failure else None
    try:
        report = run_with_recovery(
            logged, init_state, batch_at, total_steps=args.steps,
            fault_cfg=FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=50),
            fail_at=fail_at)
        print(f"\ndone: steps={report.steps_run} restarts={report.restarts}")
        first = np.mean(report.losses[:10])
        last = np.mean(report.losses[-10:])
        print(f"loss {first:.3f} → {last:.3f} "
              f"({'improved' if last < first else 'NO IMPROVEMENT'})")
        if not last < first:
            raise SystemExit("training failed to reduce loss")
        return report
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


class _Logged:
    """The train step, printing its metrics every 20 calls."""

    def __init__(self, step):
        self.step, self.calls = step, 0

    def __call__(self, p, s, b):
        out = self.step(p, s, b)
        self.calls += 1
        if self.calls % 20 == 0:
            m = out[2]
            print(f"  step {self.calls:4d}  loss={float(m['loss']):.4f}  "
                  f"lr={float(m['lr']):.2e}  "
                  f"gnorm={float(m['grad_norm']):.2f}")
        return out


if __name__ == "__main__":
    main()
