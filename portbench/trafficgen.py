"""The one generator of every traffic mix: ``traffic/<name>.json`` holds
the parameters, and the seed draws the token ids and which client plays
which part.

A mix has ``clients`` closed-loop clients.  Its requests come in rounds:
round ``r`` gives every client one request, and the sizes of a round are
the lists ``prompt_tokens`` and ``output_tokens`` (one entry a client),
each dealt out along a Latin square: the client in row ``k`` takes
output ``(k + r) mod n`` and prompt ``(3 k + 5 r) mod n``, so every round
serves each size once and every client cycles through all of them.  The
rows are dealt to the clients in an order drawn from the seed, so every
seed serves the same sizes at the same moments, to other clients and
with other tokens.  With ``system_prompts`` (``count`` prompts of
``tokens`` tokens, drawn once from the seed) each prompt is a system
prompt, row ``k`` taking ``(k + r) mod count``, followed by a user
message of the dealt size; without, the prompt is the dealt size alone.
Round 0's output sizes are cut to a share ``((7 k mod n) + 0.5) / n`` of
the dealt size, so the clients' requests end at spread-out times from
the start and the window opens on a steady mix rather than on one wave.

Keys: ``clients``, ``lead_in_s`` (seconds between the clients' start and
the window), ``first_token_wait_s`` (how long after the window a request
sent inside it may take to its first token), ``rounds``,
``prompt_tokens``, ``output_tokens`` and optionally ``system_prompts``
and ``drain_s`` (how long after the window every request in flight is
read on to its end, so that its tokens are judged too).  ``source``,
``taken`` and ``assumed`` say where the sizes come from.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Req:
    prompt: List[int]
    max_tokens: int


def load(name: str) -> Dict:
    """``traffic/<name>.json``, or the JSON file at the path ``name``."""
    path = Path(name)
    if path.suffix != ".json":
        path = HERE / "traffic" / f"{name}.json"
    return json.loads(path.read_text())


def _rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), tag])


def system_prompts(t: Dict, seed: int, vocab: int) -> List[List[int]]:
    sp = t.get("system_prompts")
    if not sp:
        return []
    rng = _rng(seed, 1)
    return [rng.integers(0, vocab, sp["tokens"]).tolist()
            for _ in range(sp["count"])]


def client_requests(t: Dict, seed: int, vocab: int) -> List[List[Req]]:
    """Every client's requests, in the order it sends them."""
    n = t["clients"]
    sizes_p, sizes_o = t["prompt_tokens"], t["output_tokens"]
    if len(sizes_p) != n or len(sizes_o) != n or math.gcd(15, n) != 1:
        raise ValueError("prompt_tokens and output_tokens need one entry a "
                         "client, and the count of clients no factor 3 or 5")
    systems = system_prompts(t, seed, vocab)
    rng = _rng(seed, 2)
    rows = rng.permutation(n)
    out: List[List[Req]] = [[] for _ in range(n)]
    for r in range(t["rounds"]):
        for c in range(n):
            k = int(rows[c])
            user = rng.integers(0, vocab, sizes_p[(3 * k + 5 * r) % n]).tolist()
            prompt = (systems[(k + r) % len(systems)] + user if systems
                      else user)
            m = sizes_o[(k + r) % n]
            if r == 0:
                m = max(1, round(m * ((7 * k) % n + 0.5) / n))
            out[c].append(Req(prompt, int(m)))
    return out


def warmup_requests(t: Dict, seed: int, vocab: int, slots: int
                    ) -> List[Req]:
    """Requests that touch every plan the mix's window uses: the system
    prompts first, each with the shortest message, so they are in the
    prefix cache before the rest; then every prompt size in turn.  There
    are ``slots // 2 + 1`` of them (or more, to cover every size), with
    budgets of 2 tokens upward, ending one a tick: their decode batches
    reach every power-of-two bucket up to ``slots``."""
    systems = system_prompts(t, seed, vocab)
    sizes = sorted(set(t["prompt_tokens"]))
    rng = _rng(seed, 3)
    reqs = []
    for j in range(max(slots // 2 + 1, len(systems) + len(sizes))):
        n = sizes[0] if j < len(systems) else sizes[j % len(sizes)]
        user = rng.integers(0, vocab, n).tolist()
        prompt = systems[j % len(systems)] + user if systems else user
        reqs.append(Req(prompt, min(2 + j, max(t["output_tokens"]))))
    return reqs
