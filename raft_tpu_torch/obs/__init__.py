"""Observability for the serving stack.

Port of ``raft_tpu/obs``, so far its request-span tracer (``obs.trace``):
the deterministic span tree on the injectable monotonic clock, with JSON
and Chrome trace-event exports. The metrics registry and the online
recall probe wait for the operations slice (ROADMAP A.5).
"""

from raft_tpu_torch.obs.trace import NULL_SPAN, NULL_TRACER, Span, Tracer

__all__ = ["Span", "Tracer", "NULL_SPAN", "NULL_TRACER"]
