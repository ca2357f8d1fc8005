"""Load generator for the PyTorch/CUDA port's HTTP serving front end
(``serve_http_torch.py``), over the port's client
(``repro_torch.serving.client``).

    PYTHONPATH=src python examples/load_client_torch.py --port 8008 \
        --n 16 --concurrency 8 [--scrape-metrics out/metrics.prom] \
        [--dump-flight out/flight.json] [--check-trace-coverage 0.9] \
        [--shutdown]

Fires ``--n`` streaming ``/v1/completions`` requests with ``--concurrency``
in flight, then reports TTFT/latency percentiles, admission rejects and —
because decoding is greedy/deterministic — verifies every stream's SSE
chunks arrive in order (contiguous ``token_index``) with zero duplicated
or dropped tokens.  Exits non-zero on any integrity failure, so CI can
gate on it.
"""

import argparse
import asyncio
import random
import sys

from repro_torch.serving import client


def _pct(xs, p):
    if not xs:
        return float("nan")
    xs = sorted(xs)
    rank = (p / 100) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


async def amain(args) -> int:
    await client.wait_ready(args.host, args.port, timeout_s=args.ready_s)
    rng = random.Random(args.seed)
    sem = asyncio.Semaphore(args.concurrency)
    vocab = args.vocab
    # the chatbot workload shape: --shared-prefix-frac of the requests
    # open with the same "system prompt" (long enough to span the
    # server's default prefix-cache hash block) before a short unique
    # tail, so the server's prefix cache can serve the shared part
    shared_prefix = [rng.randrange(vocab)
                     for _ in range(args.shared_prefix_len)]

    async def one(i):
        if rng.random() < args.shared_prefix_frac:
            prompt = shared_prefix + [rng.randrange(vocab) for _ in
                                      range(rng.randrange(2, 5))]
        else:
            prompt = [rng.randrange(vocab) for _ in
                      range(rng.randrange(4, 9))]
        payload = {"model": "transql-tiny", "prompt": prompt,
                   "max_tokens": args.max_tokens}
        async with sem:
            return await client.stream_completion(args.host, args.port,
                                                  payload)
    results = await asyncio.gather(*(one(i) for i in range(args.n)))

    ok = [r for r in results if r.status == 200]
    rejected = [r for r in results if r.status == 429]
    failures = []
    for i, r in enumerate(ok):
        want = list(range(args.max_tokens))
        if r.token_indices != want:
            failures.append(
                f"stream {i}: token_index {r.token_indices} != {want} "
                f"(duplicated, dropped or out-of-order chunks)")
    ttfts = [r.ttft_s for r in ok if r.ttft_s == r.ttft_s]
    totals = [r.total_s for r in ok]
    print(f"requests: {args.n}  ok: {len(ok)}  429: {len(rejected)}  "
          f"other: {args.n - len(ok) - len(rejected)}")
    print(f"ttft:  p50={_pct(ttfts, 50)*1e3:.1f} ms  "
          f"p95={_pct(ttfts, 95)*1e3:.1f} ms")
    print(f"total: p50={_pct(totals, 50)*1e3:.1f} ms  "
          f"p95={_pct(totals, 95)*1e3:.1f} ms")
    for f in failures:
        print(f"FAIL {f}")

    if args.scrape_metrics:
        resp = await client.request(args.host, args.port, "GET", "/metrics")
        with open(args.scrape_metrics, "w") as fh:
            fh.write(resp.body.decode())
        print(f"metrics scraped to {args.scrape_metrics}")
    if args.dump_flight:
        resp = await client.request(args.host, args.port, "GET",
                                    "/debug/flight")
        if resp.status != 200:
            print(f"FAIL /debug/flight -> {resp.status}")
            failures.append("/debug/flight not OK")
        else:
            with open(args.dump_flight, "w") as fh:
                fh.write(resp.body.decode())
            flight = resp.json()
            print(f"flight dump ({flight.get('retained_ticks', 0)} ticks, "
                  f"{flight.get('dropped_ticks', 0)} dropped) saved to "
                  f"{args.dump_flight}")
    if args.check_trace_coverage is not None:
        # pivot from a streamed chunk's trace_id to the request's
        # reconstructed end-to-end trace, and gate on how much of its
        # tick wall time the named spans attribute
        tid = next((r.trace_id for r in ok if r.trace_id), None)
        if tid is None:
            print("FAIL no trace_id on any streamed chunk")
            failures.append("no trace_id in stream chunks")
        else:
            resp = await client.request(args.host, args.port, "GET",
                                        f"/debug/trace/{tid}")
            if resp.status != 200:
                print(f"FAIL /debug/trace/{tid} -> {resp.status}")
                failures.append("trace endpoint not OK")
            else:
                trace = resp.json()
                cov = trace.get("coverage", 0.0)
                kinds = [t.get("kind") for t in trace.get("ticks", [])]
                print(f"trace {tid}: {len(kinds)} ticks {sorted(set(kinds))} "
                      f"coverage={cov:.3f} (need >= "
                      f"{args.check_trace_coverage})")
                if cov < args.check_trace_coverage:
                    print(f"FAIL trace coverage {cov:.3f} < "
                          f"{args.check_trace_coverage}")
                    failures.append("trace coverage below threshold")
                if "admission" not in kinds or "prefill" not in kinds:
                    print(f"FAIL trace missing admission/prefill ticks: "
                          f"{kinds}")
                    failures.append("trace missing lifecycle ticks")
    if args.shutdown:
        await client.request(args.host, args.port, "POST", "/admin/shutdown")
        print("server shutdown requested")

    if failures:
        return 1
    if not ok:
        print("FAIL no request succeeded")
        return 1
    return 0


def main():
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=6)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0,
                    help="fraction of requests sharing a fixed prompt "
                         "prefix (prefix-cache workload shape)")
    ap.add_argument("--shared-prefix-len", type=int, default=16,
                    help="length of the shared prefix in tokens (>= the "
                         "server's prefix-cache hash block to be hittable)")
    ap.add_argument("--ready-s", type=float, default=120.0,
                    help="seconds to wait for the server to come up")
    ap.add_argument("--scrape-metrics", default=None,
                    help="file to save a final /metrics scrape into")
    ap.add_argument("--dump-flight", default=None,
                    help="file to save a final /debug/flight dump into")
    ap.add_argument("--check-trace-coverage", type=float, default=None,
                    help="fetch /debug/trace/{trace_id} for one streamed "
                         "request and fail below this span-attribution "
                         "fraction (e.g. 0.9)")
    ap.add_argument("--shutdown", action="store_true",
                    help="POST /admin/shutdown when done (CI teardown)")
    args = ap.parse_args()
    sys.exit(asyncio.run(amain(args)))


if __name__ == "__main__":
    main()
