"""Minimal stdlib asyncio HTTP/SSE client for the serving front end.

Used by the load generator (``examples/load_client.py``) and the e2e
tests — one dependency-light way to drive ``AsyncLLMServer`` with real
sockets, parse SSE streams, and check token exactness.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HttpResponse:
    status: int
    headers: Dict[str, str]
    body: bytes

    def json(self) -> Dict:
        return json.loads(self.body or b"{}")


@dataclasses.dataclass
class StreamResult:
    """One fully consumed SSE completion stream."""

    status: int
    headers: Dict[str, str]
    events: List[Dict]          # parsed chunk JSONs, [DONE] excluded
    ttft_s: float               # connect → first SSE chunk
    total_s: float
    error: Optional[Dict] = None   # error envelope on non-200

    @property
    def tokens(self) -> List[int]:
        return [e["choices"][0]["token_id"] for e in self.events]

    @property
    def token_indices(self) -> List[int]:
        return [e["choices"][0]["token_index"] for e in self.events]

    @property
    def trace_id(self) -> Optional[str]:
        """The request's end-to-end trace id (server extension field on
        every chunk) — the key for ``GET /debug/trace/{trace_id}``."""
        for e in self.events:
            if e.get("trace_id"):
                return e["trace_id"]
        return None


async def _read_head(reader) -> Tuple[int, Dict[str, str]]:
    status_line = await reader.readline()
    status = int(status_line.split()[1])
    headers: Dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


def _encode_request(method: str, path: str, body: bytes) -> bytes:
    head = (f"{method} {path} HTTP/1.1\r\n"
            f"Host: localhost\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
    return head.encode() + body


async def request(host: str, port: int, method: str, path: str,
                  payload: Optional[Dict] = None) -> HttpResponse:
    """One non-streaming HTTP request (Connection: close framing)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps(payload).encode() if payload is not None else b""
        writer.write(_encode_request(method, path, body))
        await writer.drain()
        status, headers = await _read_head(reader)
        if "content-length" in headers:
            data = await reader.readexactly(int(headers["content-length"]))
        else:
            data = await reader.read()
        return HttpResponse(status, headers, data)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


async def stream_completion(host: str, port: int, payload: Dict,
                            path: str = "/v1/completions") -> StreamResult:
    """POST a streaming completion and consume the SSE stream fully."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps({**payload, "stream": True}).encode()
        writer.write(_encode_request("POST", path, body))
        await writer.drain()
        status, headers = await _read_head(reader)
        if status != 200:
            if "content-length" in headers:
                data = await reader.readexactly(
                    int(headers["content-length"]))
            else:
                data = await reader.read()
            return StreamResult(status, headers, [], float("nan"),
                                time.perf_counter() - t0,
                                error=json.loads(data or b"{}"))
        events: List[Dict] = []
        ttft = float("nan")
        buf = b""
        while True:
            chunk = await reader.read(4096)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                for line in frame.splitlines():
                    if not line.startswith(b"data: "):
                        continue
                    data = line[len(b"data: "):]
                    if data == b"[DONE]":
                        return StreamResult(status, headers, events, ttft,
                                            time.perf_counter() - t0)
                    if not events:
                        ttft = time.perf_counter() - t0
                    events.append(json.loads(data))
        return StreamResult(status, headers, events, ttft,
                            time.perf_counter() - t0)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


async def wait_ready(host: str, port: int, timeout_s: float = 30.0) -> None:
    """Poll /healthz until the server accepts connections."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            resp = await request(host, port, "GET", "/healthz")
            if resp.status == 200:
                return
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"server at {host}:{port} not ready after {timeout_s}s")
        await asyncio.sleep(0.2)
