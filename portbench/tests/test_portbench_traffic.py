"""The traffic generator: the same seed gives the same requests, and
every seed serves the same sizes at the same moments."""

import json
from pathlib import Path

import pytest

from portbench import trafficgen

BENCH = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json")
                   .read_text())


@pytest.mark.parametrize("traffic", sorted({c["traffic"]
                                            for c in BENCH["workloads"]}))
def test_seeds_share_the_schedule(traffic):
    t = trafficgen.load(traffic)
    a = trafficgen.client_requests(t, 2 ** 31 + 11, 32768)
    again = trafficgen.client_requests(t, 2 ** 31 + 11, 32768)
    b = trafficgen.client_requests(t, 987654321987, 32768)
    assert [[r.prompt for r in c] for c in a] == \
        [[r.prompt for r in c] for c in again]
    assert a[0][1].prompt != b[0][1].prompt
    for r in range(t["rounds"]):
        sizes = [sorted((len(c[r].prompt), c[r].max_tokens) for c in x)
                 for x in (a, b)]
        assert sizes[0] == sizes[1]
    # each client meets every output size once in n rounds
    n = t["clients"]
    assert sorted(c.max_tokens for c in a[0][1:n + 1]) == \
        sorted(t["output_tokens"])


@pytest.mark.parametrize("traffic", sorted({c["traffic"]
                                            for c in BENCH["workloads"]}))
def test_warm_up_touches_every_size(traffic):
    t = trafficgen.load(traffic)
    reqs = trafficgen.warmup_requests(t, 7, 32768, 16)
    system = t.get("system_prompts", {}).get("tokens", 0)
    assert {len(r.prompt) - system for r in reqs} == set(t["prompt_tokens"])
    assert len(reqs) >= 9     # batches of 9 down to 1: buckets 16 .. 1
    assert sorted(r.max_tokens for r in reqs) == list(range(2, 2 + len(reqs)))
