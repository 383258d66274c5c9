"""Request-level trace spans on the telemetry stream — the port's copy of
the writer half of the JAX package's ``telemetry/trace.py``.

A ``span`` event carries ``trace_id`` (one request end to end),
``span_id``, ``parent_id``, ``name``, ``t0``/``t1`` (epoch seconds) and
free-form ``attrs``. A trace context ``{"trace_id", "parent_id"[, "t0"]}``
handed in by an upstream layer joins its spans to that trace.
"""

from __future__ import annotations

import os
from typing import Any

#: the event kind span records ride the stream under
SPAN_KIND = "span"


def new_trace_id() -> str:
    return os.urandom(8).hex()


def new_span_id() -> str:
    return os.urandom(4).hex()


def span(trace_id: str, span_id: str, name: str, t0: float, t1: float | None,
         *, parent_id: str | None = None, **attrs: Any) -> dict[str, Any]:
    """One span record (the fields of a ``span`` event)."""
    rec: dict[str, Any] = {
        "trace_id": trace_id, "span_id": span_id, "name": name,
        "t0": float(t0), "t1": None if t1 is None else float(t1),
    }
    if parent_id is not None:
        rec["parent_id"] = parent_id
    if attrs:
        rec["attrs"] = attrs
    return rec


class SpanBuffer:
    """Per-request span collector: spans append host-side, and the owner
    writes :attr:`records` with one ``emit_many`` at completion."""

    def __init__(self, trace_id: str | None = None,
                 parent_id: str | None = None):
        self.trace_id = trace_id or new_trace_id()
        self.parent_id = parent_id
        self.records: list[dict[str, Any]] = []

    @classmethod
    def from_context(cls, ctx: dict | None) -> "SpanBuffer":
        """Join an upstream trace, or start a fresh one when there is none."""
        if not isinstance(ctx, dict) or not ctx.get("trace_id"):
            return cls()
        return cls(str(ctx["trace_id"]),
                   str(ctx["parent_id"]) if ctx.get("parent_id") else None)

    @property
    def joined(self) -> bool:
        """True when this buffer continues an upstream trace."""
        return self.parent_id is not None

    @staticmethod
    def upstream_t0(ctx: dict | None, default: float) -> float:
        """The upstream context's request-start time ``t0``, clamped to
        ``default`` (the local submit time)."""
        if isinstance(ctx, dict) and ctx.get("t0") is not None:
            try:
                return min(default, float(ctx["t0"]))
            except (TypeError, ValueError):
                pass
        return default

    def add(self, name: str, t0: float, t1: float | None, *,
            parent_id: str | None = None, **attrs: Any) -> str:
        sid = new_span_id()
        self.records.append(span(
            self.trace_id, sid, name, t0, t1,
            parent_id=parent_id if parent_id is not None else self.parent_id,
            **attrs))
        return sid
