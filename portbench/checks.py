"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the engine is freed, every request the
server finished (those the load generator read to their end: inside the
window and, where the mix has ``drain_s``, after it) goes through the
reference (``references/``): each prompt with its served tokens,
teacher-forced.  At every served position the number compared is the
gap by which the served token's logit lies below the reference's best;
the widest gap over the sample must stay under the configuration's
limit.  The sample must reach ``min_served_positions`` served tokens, and
no stream may be broken (an HTTP error, a token index out of order, a
stream that ends early).

``control=True`` also judges the control, with the same ``verdict``: the
reference in TF32, the precision just below the configuration's float32,
put in the program's place at the same positions.  Its gap is that, in
the float32 reference, of the token TF32 puts first; a sound check finds
it not correct.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from portbench.model import architecture


def broken(rec: Dict) -> bool:
    """An HTTP error, a broken stream, indices out of order, or a stream
    that said ``[DONE]`` short of its budget."""
    if rec["status"] != 200 or rec["error"] is not None:
        return True
    if rec["idx"] != list(range(len(rec["idx"]))):
        return True
    return rec["done"] and len(rec["tokens"]) != rec["max_tokens"]


def finished(records: List[Dict]) -> List[Dict]:
    return [r for r in records if r["done"] and not broken(r)
            and r["tokens"]]


def _gaps(ref: List[torch.Tensor], picks: List[torch.Tensor],
          over: float = float("inf")):
    """The widest gap; with ``over``, also how many positions exceed it."""
    worst, n_over = 0.0, 0
    for lg, tok in zip(ref, picks):
        rows = torch.arange(len(tok), device=lg.device)
        gap = lg.max(dim=-1).values - lg[rows, tok.to(lg.device)]
        worst = max(worst, float(gap.max()))
        n_over += int((gap > over).sum())
    return worst if over == float("inf") else (worst, n_over)


def verdict(limits: Dict, gap: float, served: int, n_broken: int) -> Dict:
    """``{"checks": {name: {"value", "limit"}}, "correct": bool}`` of one
    side, the program or the control."""
    finite = gap if gap != float("inf") else None
    checks = {
        "max_logit_gap": {"value": finite, "limit": limits["max_logit_gap"]},
        "min_served_positions": {"value": served,
                                 "limit": limits["min_served_positions"]},
        "broken_streams": {"value": n_broken, "limit": 0}}
    correct = (gap <= limits["max_logit_gap"]
               and served >= limits["min_served_positions"]
               and n_broken == 0)
    return {"checks": checks, "correct": bool(correct)}


def judge(cfg: Dict, seed: int, records: List[Dict], device,
          control: bool = False) -> Dict:
    """The program's ``verdict`` and, with ``control``, the control's
    under ``"control"``."""
    s = architecture(cfg).shapes(cfg)
    ref = importlib.import_module(f"portbench.references.{cfg['reference']}")
    picked = finished(records)
    served = sum(len(r["tokens"]) for r in picked)
    n_broken = sum(broken(r) for r in records)
    gap = ctl = float("inf")
    n_over = 0
    if picked:
        seqs = [r["prompt"] + r["tokens"][:-1] for r in picked]
        first = [len(r["prompt"]) - 1 for r in picked]
        toks = [torch.as_tensor(r["tokens"]) for r in picked]
        lg = ref.logits(s, seed, seqs, first, device, "f32")
        gap = _gaps(lg, toks)
        if control:
            low = ref.logits(s, seed, seqs, first, device, "tf32")
            ctl, n_over = _gaps(lg, [x.argmax(dim=-1) for x in low],
                                cfg["checks"]["max_logit_gap"])
            del low
        del lg
    out = verdict(cfg["checks"], gap, served, n_broken)
    if control:
        out["control"] = verdict(cfg["checks"], ctl, served, n_broken)
        # how many positions read over the limit: the rate at which a
        # sample of this size catches the control
        out["control"]["positions_over_limit"] = n_over
    return out
