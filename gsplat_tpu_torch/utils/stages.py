"""The port's tracer: named stages of a render or a training step, host
syncs and counters, recorded on request.

Turning it on::

    from gsplat_tpu_torch.utils import stages

    with stages.record_stages() as rec:
        for i in range(steps):
            with stages.step(i):          # the step or request id
                train_or_render(i)
        torch.cuda.synchronize()          # the fence; then read:
    rec.spans                             # one Span a stage, as it ends
    rec.counter_values()                  # (name, step, value), read now

The render pipeline, the rasterizers' autograd functions, the loss and the
trainer mark their stages with ``stage(name)``, host syncs with
``sync(name)``; marks that are not blocks use ``begin(name)`` /
``end(token)``. The backward's boundaries are identity autograd functions
(``opens_backward`` / ``closes_backward``), put into the graph only while
recording: ``loss_bwd`` runs from the loss output's backward to the
backward of the rasterizer's ``[T, npix, *]`` tiles, ``preprocess_bwd`` from
``feat``'s backward to that of the tensors the preprocess reads from the
model. ``count(name, value)`` notes a counter (pairs binned, pair demand
and overflow, slices, the slice budget reached, host syncs, compacted
reductions, ``reduced_pairs``: the pair rows the backward's reductions
read, from shapes; ``gather_bytes`` and ``reduce_bytes``: what the mesh's
collectives gather and sum, from shapes); a device value is kept by
reference and read once by ``counter_values()``, after the caller's fence,
so no counter adds a sync or a kernel.

A :class:`Span` holds its name, the span that caused it (the enclosing one
on its own thread; for the first span on autograd's thread, the span open
on the thread that called backward), the step id, its thread, its host
start and end in ns on the clock of ``torch.profiler``'s events (Unix-epoch
ns, ``time.time_ns``), and with a CUDA device the CUDA events recorded on
the current stream at its start and end (device time in stream order, the
host's launch gaps included). Without one it holds host time alone.

Cost: outside ``record_stages()`` every mark, counter, sync flag and step
id reads one global and does nothing else; no autograd node is added. Inside
it, a span costs two clock reads and a few list operations on the host
(about 11 µs a span on the H100's host, 8 on a desktop CPU), a counter one
append, plus two CUDA events: the first record of a new event cost 172 µs
on the H100's host, so ``record_stages(events=False)`` records host time
alone.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

now_ns = time.time_ns  # the clock of torch.profiler's events

_rec: Optional["Recording"] = None
_step: Optional[int] = None


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # id of the span that caused it
    step: Optional[int]
    thread: int  # threading.get_native_id()
    host_start_ns: int
    host_end_ns: int
    start: Optional["torch.cuda.Event"]
    end: Optional["torch.cuda.Event"]
    sync: bool  # a host sync: its host time is the wait


class Counter(NamedTuple):
    name: str
    step: Optional[int]
    value: object  # an int, or a tensor read by counter_values()
    above: Optional[int]  # read as max(value - above, 0)


class _Open:
    __slots__ = ("name", "id", "parent", "step", "thread", "stack", "t0", "ev0", "sync")


class Recording(list):
    """Every stage recorded, as ``(name, start event, end event)`` in the
    order stages end (an inner stage before the one around it; the events
    are None without a CUDA device), with the full records in ``spans``
    and the counters in ``counters``."""

    def __init__(self, events: bool):
        super().__init__()
        self.spans: List[Span] = []
        self.counters: List[Counter] = []
        self._events = events
        self._ids = itertools.count()
        self._local = threading.local()
        self._stacks: Dict[int, List[_Open]] = {}

    def _stack(self) -> List[_Open]:
        stack = getattr(self._local, "stack", None)
        if stack is None:  # the thread's id read once: it is a system call
            stack = self._local.stack = []
            self._local.thread = threading.get_native_id()
            self._stacks[self._local.thread] = stack
        return stack

    def innermost(self, name: str) -> Optional[_Open]:
        """The innermost span ``name`` open on this thread."""
        for s in reversed(self._stack()):
            if s.name == name:
                return s
        return None

    def _event(self):
        if not self._events:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def open(self, name: str, sync: bool = False) -> _Open:
        stack = self._stack()
        s = _Open()
        s.name, s.id, s.step, s.sync = name, next(self._ids), _step, sync
        s.thread, s.stack = self._local.thread, stack
        if stack:
            s.parent = stack[-1].id
        else:  # the newest span open on another thread (the one that called backward)
            tops = [t[-1].id for t in list(self._stacks.values()) if t and t is not stack]
            s.parent = max(tops) if tops else None
        stack.append(s)
        s.ev0 = self._event()
        s.t0 = now_ns()
        return s

    def close(self, s: _Open) -> None:
        t1 = now_ns()
        ev1 = self._event()
        if s in s.stack:
            s.stack.remove(s)
        self.spans.append(Span(s.name, s.id, s.parent, s.step, s.thread, s.t0, t1, s.ev0, ev1, s.sync))
        self.append((s.name, s.ev0, ev1))
        if s.sync:
            self.counters.append(Counter("host_syncs", s.step, 1, None))

    def counter_values(self) -> List[Tuple[str, Optional[int], int]]:
        """``(name, step, value)`` of every counter, device values read now
        (after the caller's fence)."""
        out = []
        for c in self.counters:
            v = int(c.value)
            out.append((c.name, c.step, v if c.above is None else max(v - c.above, 0)))
        return out


@contextlib.contextmanager
def stage(name: str):
    """Mark the enclosed code as stage ``name``."""
    rec = _rec
    if rec is None:
        yield
        return
    s = rec.open(name)
    yield
    rec.close(s)


@contextlib.contextmanager
def sync(name: str):
    """Mark the enclosed host sync as the sync span ``name`` (and count it
    in ``host_syncs``)."""
    rec = _rec
    if rec is None:
        yield
        return
    s = rec.open(name, sync=True)
    yield
    rec.close(s)


def begin(name: str):
    """Open the span ``name``; returns the token ``end`` takes (None while
    not recording)."""
    rec = _rec
    if rec is None:
        return None
    return rec.open(name)


def end(token) -> None:
    """Close the span ``begin`` opened."""
    rec = _rec
    if rec is None or token is None:
        return
    rec.close(token)


def count(name: str, value, above: Optional[int] = None) -> None:
    """Note counter ``name`` at ``value`` (an int, or a tensor kept by
    reference); with ``above``, what it reads is ``max(value - above, 0)``."""
    rec = _rec
    if rec is None:
        return
    rec.counters.append(Counter(name, _step, value, above))


@contextlib.contextmanager
def step(i: int):
    """Give the spans and counters recorded inside the step or request id
    ``i`` (on autograd's thread too)."""
    global _step
    if _rec is None:
        yield
        return
    saved, _step = _step, i
    try:
        yield
    finally:
        _step = saved


class _BackwardMark(torch.autograd.Function):
    """Identity; its backward opens or closes the span ``name``."""

    @staticmethod
    def forward(ctx, name, opens, *xs):
        ctx.name, ctx.opens = name, opens
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.opens:
            begin(ctx.name)
        else:
            rec = _rec
            end(rec.innermost(ctx.name) if rec is not None else None)
        return (None, None) + grads


def opens_backward(name: str, x: torch.Tensor) -> torch.Tensor:
    """``x``; while recording under grad, through an identity node whose
    backward opens the span ``name``."""
    if _rec is None or not torch.is_grad_enabled():
        return x
    return _BackwardMark.apply(name, True, x)[0]


def closes_backward(name: str, *xs: torch.Tensor) -> tuple:
    """``xs``; while recording under grad, through one identity node whose
    backward (once every one of their gradients is in) closes the span
    ``name`` open on its thread."""
    if _rec is None or not torch.is_grad_enabled():
        return xs
    return _BackwardMark.apply(name, False, *xs)


@contextlib.contextmanager
def record_stages(events: bool = True):
    """Record every stage, sync and counter marked while active. Yields the
    :class:`Recording`; read its CUDA events' ``elapsed_time`` and its
    ``counter_values()`` after ``torch.cuda.synchronize()``. CUDA events
    are recorded where CUDA is available, unless ``events`` is False (host
    time alone: a new event's first record costs the host far more than
    the rest of a span)."""
    global _rec, _step
    rec = Recording(events and torch.cuda.is_available())
    _rec, _step = rec, None
    try:
        yield rec
    finally:
        _rec, _step = None, None
