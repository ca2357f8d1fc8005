"""OpenAI-compatible request/response schema for the async serving front
end (``repro_torch.serving.server``).

Wire format only — no engine imports.  The repo's toy models carry no
real tokenizer, so prompts are primarily *token-id lists* (the OpenAI
``/v1/completions`` schema allows token-array prompts); plain-string
prompts/chat content are encoded through :class:`ToyTokenizer`
(codepoint % vocab per character) so every endpoint stays drivable with
ordinary text clients.  Response ``text`` fields are the decoded tokens
(space-joined ids), and each choice additionally carries the raw
``token_ids`` so exactness-checking clients (the load generator, the
e2e tests) never round-trip through the toy text encoding.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Union


class ApiError(Exception):
    """HTTP-mappable request error (OpenAI error envelope)."""

    def __init__(self, status: int, message: str, code: str = "bad_request",
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.status = status
        self.code = code
        self.retry_after_s = retry_after_s

    def to_dict(self) -> Dict:
        return {"error": {"message": str(self), "type": self.code,
                          "code": self.code}}


class ToyTokenizer:
    """Deterministic text<->token bridge for vocab-limited toy models."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text: str) -> List[int]:
        return [ord(c) % self.vocab for c in text]

    def decode(self, tokens: List[int]) -> str:
        return " ".join(str(int(t)) for t in tokens)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ApiError(400, message)


def _parse_tokens(value: Union[str, List], field: str,
                  tokenizer: ToyTokenizer) -> List[int]:
    if isinstance(value, str):
        toks = tokenizer.encode(value)
        _require(bool(toks), f"{field!r} must be non-empty")
        return toks
    _require(isinstance(value, list) and bool(value),
             f"{field!r} must be a non-empty string or token-id list")
    _require(all(isinstance(t, int) and not isinstance(t, bool)
                 for t in value),
             f"{field!r} token list must contain only integers")
    return [int(t) for t in value]


def _opt_seconds(body: Dict, field: str) -> Optional[float]:
    """Extension SLO knobs ride in milliseconds (``*_slo_ms``)."""
    v = body.get(field)
    if v is None:
        return None
    _require(isinstance(v, (int, float)) and v > 0,
             f"{field!r} must be a positive number of milliseconds")
    return float(v) / 1e3


@dataclasses.dataclass
class CompletionRequest:
    """Parsed ``/v1/completions`` body (one choice, greedy decoding)."""

    prompt: List[int]
    max_tokens: int
    stream: bool
    model: Optional[str] = None
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    echo_messages: Optional[List[Dict]] = None  # set for chat requests

    @property
    def is_chat(self) -> bool:
        return self.echo_messages is not None

    @classmethod
    def parse(cls, body: Dict, tokenizer: ToyTokenizer
              ) -> "CompletionRequest":
        _require(isinstance(body, dict), "request body must be a JSON object")
        _require("prompt" in body, "'prompt' is required")
        _require(body.get("n", 1) == 1, "only n=1 is supported")
        prompt = _parse_tokens(body["prompt"], "prompt", tokenizer)
        max_tokens = body.get("max_tokens", 16)
        _require(isinstance(max_tokens, int) and max_tokens >= 1,
                 "'max_tokens' must be a positive integer")
        return cls(prompt=prompt, max_tokens=max_tokens,
                   stream=bool(body.get("stream", False)),
                   model=body.get("model"),
                   ttft_slo_s=_opt_seconds(body, "ttft_slo_ms"),
                   tpot_slo_s=_opt_seconds(body, "tpot_slo_ms"))

    @classmethod
    def parse_chat(cls, body: Dict, tokenizer: ToyTokenizer
                   ) -> "CompletionRequest":
        _require(isinstance(body, dict), "request body must be a JSON object")
        msgs = body.get("messages")
        _require(isinstance(msgs, list) and bool(msgs),
                 "'messages' must be a non-empty list")
        prompt: List[int] = []
        for m in msgs:
            _require(isinstance(m, dict) and isinstance(m.get("role"), str)
                     and "content" in m,
                     "each message needs 'role' and 'content'")
            prompt.extend(_parse_tokens(m["content"],
                                        "messages[].content", tokenizer))
        _require(body.get("n", 1) == 1, "only n=1 is supported")
        max_tokens = body.get("max_tokens", 16)
        _require(isinstance(max_tokens, int) and max_tokens >= 1,
                 "'max_tokens' must be a positive integer")
        return cls(prompt=prompt, max_tokens=max_tokens,
                   stream=bool(body.get("stream", False)),
                   model=body.get("model"),
                   ttft_slo_s=_opt_seconds(body, "ttft_slo_ms"),
                   tpot_slo_s=_opt_seconds(body, "tpot_slo_ms"),
                   echo_messages=msgs)


def _usage(prompt_tokens: int, completion_tokens: int,
           cached_tokens: int = 0) -> Dict:
    # prompt_tokens_details.cached_tokens is the OpenAI wire field for
    # prompt tokens served from a prefix cache instead of recomputed
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
            "prompt_tokens_details": {"cached_tokens": int(cached_tokens)}}


def completion_response(rid: int, model: str, req: CompletionRequest,
                        tokens: List[int], tokenizer: ToyTokenizer,
                        cached_tokens: int = 0,
                        trace_id: Optional[str] = None) -> Dict:
    # trace_id is an extension field: the request-scoped id minted at
    # admission, the handle for GET /debug/trace/{trace_id}
    out: Dict
    if req.is_chat:
        out = {
            "id": f"chatcmpl-{rid}", "object": "chat.completion",
            "created": int(time.time()), "model": model,
            "choices": [{"index": 0,
                         "message": {"role": "assistant",
                                     "content": tokenizer.decode(tokens)},
                         "token_ids": tokens,
                         "finish_reason": "length"}],
            "usage": _usage(len(req.prompt), len(tokens), cached_tokens)}
    else:
        out = {
            "id": f"cmpl-{rid}", "object": "text_completion",
            "created": int(time.time()), "model": model,
            "choices": [{"index": 0, "text": tokenizer.decode(tokens),
                         "token_ids": tokens, "finish_reason": "length"}],
            "usage": _usage(len(req.prompt), len(tokens), cached_tokens)}
    if trace_id:
        out["trace_id"] = trace_id
    return out


def stream_chunk(rid: int, model: str, req: CompletionRequest,
                 token: int, token_index: int, tokenizer: ToyTokenizer,
                 finish: bool, trace_id: Optional[str] = None) -> Dict:
    """One SSE chunk for one generated token.

    ``token_index`` is the 0-based position in the generation — an
    explicit ordering/dedupe handle for streaming consumers (the
    preemption-replay regression surface), beyond what OpenAI's schema
    carries.  ``trace_id`` (extension field) lets a streaming client
    pivot straight to ``GET /debug/trace/{trace_id}``.
    """
    text = (" " if token_index else "") + tokenizer.decode([token])
    out: Dict
    if req.is_chat:
        delta = {"content": text}
        if token_index == 0:
            delta["role"] = "assistant"
        out = {
            "id": f"chatcmpl-{rid}", "object": "chat.completion.chunk",
            "created": int(time.time()), "model": model,
            "choices": [{"index": 0, "delta": delta,
                         "token_id": int(token),
                         "token_index": token_index,
                         "finish_reason": "length" if finish else None}]}
    else:
        out = {
            "id": f"cmpl-{rid}", "object": "text_completion",
            "created": int(time.time()), "model": model,
            "choices": [{"index": 0, "text": text,
                         "token_id": int(token), "token_index": token_index,
                         "finish_reason": "length" if finish else None}]}
    if trace_id:
        out["trace_id"] = trace_id
    return out


def models_response(model: str) -> Dict:
    return {"object": "list",
            "data": [{"id": model, "object": "model",
                      "created": int(time.time()),
                      "owned_by": "transql-repro"}]}


# -- SSE framing ------------------------------------------------------------

SSE_DONE = b"data: [DONE]\n\n"


def sse_event(data: Dict) -> bytes:
    return b"data: " + json.dumps(data, separators=(",", ":")).encode() \
        + b"\n\n"
