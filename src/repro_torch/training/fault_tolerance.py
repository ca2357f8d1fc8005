"""Fault-tolerant training driver: checkpoint/restart, failure injection,
straggler mitigation.

The driver owns the outer loop: it restores the newest checkpoint (if any),
replays the data cursor to the restored step, runs jit-ted steps with a
per-step deadline, snapshots asynchronously every ``ckpt_every`` steps, and
— on any step exception or injected failure — tears down and restarts from
the last durable snapshot.  Straggler handling at real scale is
host-level (a slow worker misses the deadline and the coordinator excludes
it before the next elastic restart); here the deadline monitor records
violations and the elastic path is exercised by restoring onto a different
mesh (tests/test_training.py).

A copy of the reference's driver.  ``float(loss)`` is the step's
synchronise; a checkpoint is restored onto the device of the state that
``init_state`` returns.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.models.transformer import tree_leaves
from repro_torch.training import checkpoint as ckpt_lib


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    step_deadline_s: float = 0.0   # 0 disables the straggler monitor
    max_restarts: int = 3


@dataclasses.dataclass
class RunReport:
    steps_run: int
    restarts: int
    straggler_events: List[int]
    final_loss: float
    losses: List[float]


def run_with_recovery(
    train_step: Callable,          # (params, opt_state, batch) -> (p, s, m)
    init_state: Callable,          # () -> (params, opt_state)
    batch_at: Callable,            # (step) -> host batch
    total_steps: int,
    fault_cfg: FaultConfig,
    abstract_state=None,           # for restore; default: from init_state()
    fail_at: Optional[Dict[int, int]] = None,  # {step: restart_idx} injected
) -> RunReport:
    """Outer driver loop. ``fail_at`` injects a crash the first time the
    given step is reached on the given restart index (testing hook)."""
    restarts = 0
    straggler_events: List[int] = []
    losses: List[float] = []
    ckpter = ckpt_lib.AsyncCheckpointer(fault_cfg.ckpt_dir)

    while True:
        # ---- (re)initialise or restore --------------------------------------
        params, opt_state = init_state()
        start_step = 0
        last = ckpt_lib.latest_step(fault_cfg.ckpt_dir)
        if last is not None:
            tree, manifest = ckpt_lib.restore(
                fault_cfg.ckpt_dir, last, (params, opt_state),
                device=next(tree_leaves(params)).device)
            params, opt_state = tree
            start_step = manifest["step"]

        try:
            step = start_step
            while step < total_steps:
                if fail_at and fail_at.get(step) == restarts:
                    raise RuntimeError(f"injected failure at step {step}")
                t0 = time.monotonic()
                batch = batch_at(step)
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.monotonic() - t0
                if fault_cfg.step_deadline_s and dt > fault_cfg.step_deadline_s:
                    straggler_events.append(step)
                step += 1
                if step % fault_cfg.ckpt_every == 0 or step == total_steps:
                    ckpter.save(step, (params, opt_state),
                                extra={"data_cursor": step})
                    ckpt_lib.garbage_collect(fault_cfg.ckpt_dir,
                                             fault_cfg.keep)
            ckpter.wait()
            return RunReport(steps_run=step, restarts=restarts,
                             straggler_events=straggler_events,
                             final_loss=losses[-1] if losses else float("nan"),
                             losses=losses)
        except Exception:
            ckpter.wait()
            restarts += 1
            if restarts > fault_cfg.max_restarts:
                raise
            # loop re-enters: restore from the last durable snapshot
