"""Serving: relational engine, batched decoder, KV cache, scheduler."""
