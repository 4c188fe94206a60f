"""Named stages of a render or a training step, timed on the card on request.

The render pipeline, the rasterizer's autograd function and the trainer
mark their stages with ``stage(name)``. Outside ``record_stages()`` a mark
does nothing but read one global. Inside it, a mark records a CUDA event on
the current stream where its stage starts and one where it ends, so a
stage's span is device time in stream order (the host's launch gaps
included), and it stays right for the backward's stages, which autograd
runs on a thread of its own.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

Span = Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]

_spans: Optional[List[Span]] = None


def _event() -> "torch.cuda.Event":
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@contextlib.contextmanager
def stage(name: str):
    """Mark the enclosed code as stage ``name``."""
    spans = _spans
    if spans is None:
        yield
        return
    start = _event()
    yield
    spans.append((name, start, _event()))


@contextlib.contextmanager
def record_stages():
    """Record every stage marked while active. Yields the list of
    ``(name, start event, end event)``, appended as stages end (an inner
    stage before the one around it); read the events' ``elapsed_time``
    after ``torch.cuda.synchronize()``. Needs a CUDA device."""
    global _spans
    spans: List[Span] = []
    _spans = spans
    try:
        yield spans
    finally:
        _spans = None
