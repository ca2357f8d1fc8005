"""The load generator: closed-loop clients streaming completions over HTTP.

Run as a child process of ``run.py``, so that its Python does not share
the server's interpreter lock:

    python portbench/loadgen.py --port P --traffic NAME --seed N \
        --vocab V --seconds S

Every client sends ``POST /v1/completions`` with a token-id prompt and
``stream: true``, reads the server-sent events to the end, and sends its
next request (closed loop).  The clients start together; the window
opens ``lead_in_s`` later and lasts ``--seconds``.  Its first line on
standard output gives the window's edges on the monotonic clock, which
every process of the machine shares; once the window has closed it
prints one JSON line a request.  After the close no request is sent.  A
request in flight at the close is read on to its end for ``drain_s``
(0 where the mix gives none), and one sent inside the window at least
until its first token (at most ``first_token_wait_s``); then it stops
being read.

Each record: the client and its request number, the prompt and token
budget, the send time, each token's arrival time, id and index, the HTTP
status, the server's request id, whether ``[DONE]`` arrived, and an
error, if any.  The SSE parsing is a copy of the port's
``serving/client.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import trafficgen  # noqa: E402

HOST = "127.0.0.1"


async def _read_head(reader):
    status_line = await reader.readline()
    if not status_line:
        raise ConnectionError("connection closed before the status line")
    status = int(status_line.split()[1])
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            return status


def _request_bytes(payload: Dict) -> bytes:
    body = json.dumps(payload).encode()
    head = (f"POST /v1/completions HTTP/1.1\r\nHost: localhost\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
    return head.encode() + body


async def stream_one(port: int, req: trafficgen.Req, t_open: float,
                     t_close: float, wait_s: float, drain_s: float) -> Dict:
    rec = {"prompt": req.prompt, "max_tokens": req.max_tokens,
           "sent": time.monotonic(), "times": [], "tokens": [], "idx": [],
           "status": None, "rid": None, "done": False, "error": None}
    in_window = t_open <= rec["sent"] < t_close

    def deadline():
        # a request sent in the window is read to its first token
        first = wait_s if in_window and not rec["times"] else 0.0
        return t_close + max(first, drain_s)

    writer = None
    try:
        reader, writer = await asyncio.open_connection(HOST, port)
        writer.write(_request_bytes({"prompt": req.prompt,
                                     "max_tokens": req.max_tokens,
                                     "stream": True}))
        await writer.drain()
        rec["status"] = await asyncio.wait_for(
            _read_head(reader), max(1e-3, deadline() - time.monotonic()))
        if rec["status"] != 200:
            rec["error"] = (await reader.read()).decode("utf-8", "replace")
            return rec
        buf = b""
        while not rec["done"]:
            left = deadline() - time.monotonic()
            if left <= 0:
                break
            try:
                chunk = await asyncio.wait_for(reader.read(65536), left)
            except asyncio.TimeoutError:
                break
            if not chunk:
                rec["error"] = "stream closed before [DONE]"
                break
            now = time.monotonic()
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                for line in frame.splitlines():
                    if not line.startswith(b"data: "):
                        continue
                    data = line[len(b"data: "):]
                    if data == b"[DONE]":
                        rec["done"] = True
                        continue
                    ev = json.loads(data)
                    choice = ev["choices"][0]
                    rec["rid"] = ev.get("id")
                    rec["times"].append(now)
                    rec["tokens"].append(int(choice["token_id"]))
                    rec["idx"].append(int(choice["token_index"]))
    except (OSError, asyncio.TimeoutError, ValueError, KeyError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except OSError:
                pass
    return rec


async def client(c: int, reqs: List[trafficgen.Req], port: int,
                 t_open: float, t_close: float, wait_s: float,
                 drain_s: float, out: List[Dict]) -> None:
    for k, req in enumerate(reqs):
        if time.monotonic() >= t_close:
            return
        rec = await stream_one(port, req, t_open, t_close, wait_s, drain_s)
        rec.update(client=c, k=k)
        out.append(rec)
        if rec["error"] is not None and rec["status"] != 200:
            await asyncio.sleep(0.1)  # no busy loop on a refused request


async def drive(port: int, t: Dict, reqs: List[List[trafficgen.Req]],
                seconds: float) -> List[Dict]:
    t_open = time.monotonic() + t["lead_in_s"]
    t_close = t_open + seconds
    print(json.dumps({"t_open": t_open, "t_close": t_close}), flush=True)
    out: List[Dict] = []
    await asyncio.gather(*(client(c, r, port, t_open, t_close,
                                  t["first_token_wait_s"],
                                  t.get("drain_s", 0.0), out)
                           for c, r in enumerate(reqs)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--vocab", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    t = trafficgen.load(args.traffic)
    reqs = trafficgen.client_requests(t, args.seed, args.vocab)
    records = asyncio.run(drive(args.port, t, reqs, args.seconds))
    for rec in records:
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
