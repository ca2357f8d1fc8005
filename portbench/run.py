"""Run one cell of ``BENCHMARK.json`` and print its result as one JSON line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

The cell's configuration (``configs/``) gives the model's shapes, its
architecture (``archs/<model>.py``) and the engine's settings; its
traffic (``traffic/``) the clients and the sizes.
The run builds the port's server on the CUDA card with weights drawn from
the seed, warms up every plan the traffic touches, starts the load
generator (``loadgen.py``) in a child process and measures its window.
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profile of the card over
the window.  Both judge the served tokens against the plain reference
(``checks.py``); ``--control 1`` also judges the control, the reference
in TF32 in the program's place, and prints its verdict under
``control``.  The numbers compared, each beside its limit, are the last
lines on standard error and the last key of the line.  The server is
built as the port deploys it: the harness sets no thread count, garbage
collector or allocator option of the serving process.

It exits 3, printing no result, without a CUDA card (or with fewer than
the cell asks for), and 4 if ``jax``, ``jaxlib``, ``flax`` or ``repro``
was imported.  Build and kernel caches stay under ``build/`` in the
checkout.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)

import torch  # noqa: E402

from portbench import checks, counts, devtrace, trafficgen  # noqa: E402
from portbench.window import Window, reader  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Top-level names of loaded modules that this process must not
    hold, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_bench(root: Path = ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(bench, workload: str, trace: bool):
    """``[(name, unit)]`` of the cell's end-to-end or per-layer metrics."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or workload in m["workloads"]:
            out.append((m["name"], m["unit"]))
    return out


def log(*args) -> None:
    print("portbench:", *args, file=sys.stderr, flush=True)


def _gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cfg, traffic: str, seed: int, seconds: float, trace: bool,
             metrics, device="cuda", control: bool = False, t0: float = T0,
             plant=None):
    """Build, warm up, load, measure and judge one cell; returns the
    result line (a dict).  ``plant`` is called with the built system
    before the warm-up (the tests plant faults with it)."""
    from portbench.system import GcPauses, System

    t = trafficgen.load(traffic)
    system = System(cfg, seed, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        log(f"engine built at {time.monotonic() - t0:.1f} s: "
            f"{_gib(torch.cuda.memory_allocated())} allocated")
    if plant is not None:
        plant(system)
    system.warm_up(trafficgen.warmup_requests(
        t, seed, system.shapes.vocab, system.slots))
    watch = system.watch_window(trace)
    port = system.start()
    pauses = GcPauses()
    setup_s = time.monotonic() - t0
    if cuda:
        log(f"set-up {setup_s:.1f} s: "
            f"{_gib(torch.cuda.memory_allocated())} allocated, peak "
            f"{_gib(torch.cuda.max_memory_allocated())}")
    child = subprocess.Popen(
        [sys.executable, str(ROOT / "portbench" / "loadgen.py"),
         "--port", str(port), "--traffic", traffic, "--seed", str(seed),
         "--vocab", str(system.shapes.vocab), "--seconds", str(seconds)],
        stdout=subprocess.PIPE, text=True, cwd=str(ROOT))
    try:
        edges = json.loads(child.stdout.readline())
        watch.t_close = edges["t_close"]
        watch.t_open = edges["t_open"]
        out, _ = child.communicate(
            timeout=t["lead_in_s"] + seconds + t["first_token_wait_s"]
            + t.get("drain_s", 0) + 120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise RuntimeError(f"the load generator exited {child.returncode}")
    records = [json.loads(line) for line in out.splitlines() if line]
    if not watch.closed.wait(timeout=120):
        raise RuntimeError("no engine call came after the window's close")
    pauses.close()
    gc_full = pauses.within(edges["t_open"], edges["t_close"])
    peak = system.memory_peak_bytes()
    if cuda:
        log(f"window closed: peak {_gib(peak)}, reserved "
            f"{_gib(torch.cuda.memory_reserved())}")
    dev = None
    if trace:
        t_red = time.monotonic()
        dev = devtrace.reduce(devtrace.device_events(watch.prof),
                              watch.open_ns, watch.close_ns, watch.calls())
        watch.prof = None
        log(f"trace read in {time.monotonic() - t_red:.1f} s")
    system.close()
    log(f"window: {len(records)} requests, counters "
        f"{ {k: watch.edges['close'][k] - v for k, v in watch.edges['open'].items()} }")
    if dev is not None:
        log(f"trace: {dev['events']} device events, busy {dev['busy_s']:.3f}"
            f" of {dev['window_s']:.3f} s")
    if cuda:
        log(f"engine freed: {_gib(torch.cuda.memory_allocated())} allocated")
    t_ref = time.monotonic()
    judged = checks.judge(cfg, seed, records, device, control=control)
    log(f"reference took {time.monotonic() - t_ref:.1f} s")
    w = Window(arch=system.arch, shapes=system.shapes, peaks=counts.peaks(),
               seconds=seconds, t_open=edges["t_open"],
               t_close=edges["t_close"], requests=records, setup_s=setup_s,
               prefills=watch.prefills, decodes=watch.decodes,
               edges=watch.edges,
               gate_s=(watch.close_ns - watch.open_ns) / 1e9, device=dev)
    line = assemble(w, metrics, judged, device_block(device, peak))
    line["counters"].update(gc_full=gc_full[0], gc_full_s=gc_full[1])
    line["checks"] = line.pop("checks")
    return line


def device_block(device, peak: int):
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}


def assemble(w: Window, metrics, judged, device):
    """The result line: each metric's reader over the window, the device,
    the trace's breakdown, the program's counters over the window, and
    the numbers compared, last."""
    values = {}
    for name, unit in metrics:
        v = reader(name)(w)
        if v is not None:
            values[name] = {"value": v, "unit": unit}
    sent = w.sent_in_window()
    line = {"correct": judged["correct"], "attempted": len(sent),
            "failed": sum(checks.broken(r) for r in sent),
            "metrics": values, "device": dict(device)}
    if w.device is not None:
        line["device"].update(busy_s=w.device["busy_s"],
                              window_s=w.device["window_s"])
        line["breakdown"] = w.device["breakdown"]
    line["counters"] = {k: w.delta(k) for k in w.edges.get("open", {})}
    if "control" in judged:
        line["control"] = judged["control"]
    line["checks"] = judged["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell = next((c for c in bench["workloads"]
                 if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    line = run_cell(cfg, cell["traffic"], args.seed, args.seconds,
                    bool(args.trace),
                    cell_metrics(bench, args.workload, bool(args.trace)),
                    control=bool(args.control))
    line["card"] = card()
    bad = forbidden_modules()
    if bad:
        print(f"this process imported {', '.join(bad)}", file=sys.stderr)
        return 4
    checks_ = line.pop("checks")
    line["checks"] = checks_
    if "control" in line:
        ctl = line["control"]
        print(f"control: correct {ctl['correct']}", file=sys.stderr)
        for name, c in ctl["checks"].items():
            print(f"control {name} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
    for name, c in checks_.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
