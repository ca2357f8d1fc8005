"""Observability: request-scoped trace context (``context``)."""
