"""Booked collectives over the stacked worker axis (counterpart of
``repro.core.comms``).

On one card the W data-parallel workers are a leading tensor axis, so a
collective is a stack or a sum over that axis.  Each call still books what
a real n-way collective would move: the local payload of one worker, its
wire format, the mesh axes it reduces over (``over``: ``("data",)`` by
default; ``("pod",)`` or ``("pod", "data")`` on a two-level layout) and n,
their extent, priced by the reference's ``wire_bytes`` formulas, times the
enclosing ``loop`` multiplicity.  The reference's ``model`` axis is a
stacked axis of M shards as well: the model code's tensor-parallel
collectives (:func:`model_psum`, :func:`book_model`) reduce over that axis
and are booked over ``("model",)`` whatever axes the enclosing ``over``
names.  Records are kept only inside
``capture()``, and not inside ``muted()``: a program that runs the same
collectives again (the pipelined step's later rounds, every pod's round
but the first) books them once, as the reference traces them once.

Under an active rank group (``ranks(group)``, :mod:`repro_torch.core.ranks`)
the W workers are spread over R processes, and a rank writes only its own
rows of a (W, ...) stack: :func:`all_gather` (and :func:`psum`,
:func:`pmean`, :func:`widening_psum`, which gather first) fill the other
ranks' rows for real, and :func:`reduce_partial` turns a rank's running
sum over its own workers into the sum over all W.  :func:`ppermute` takes
and returns the rank's own (W/R, ...) rows only: the rows whose source is
another rank's cross by point-to-point messages, the rest are copied.
Booking does not change: every rank books what the stacked program books,
with n = W.

The booking state is the thread's own.  A round run on another thread
(the pipelined step's communication thread) runs under the caller's state:
:func:`context` snapshots it, :func:`entered` enters a snapshot, and
:func:`closed` makes any record the caller's thread would append meanwhile
an error (the records must come out in the stacked step's order).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import torch

_STATE = threading.local()


@dataclass
class CollRecord:
    kind: str  # psum | all_gather | ppermute
    axes: tuple[str, ...]
    payload_bytes: int  # local operand bytes per call (one worker)
    mult: float
    n_workers: int = 1
    tag: str = ""
    wire_format: str = "f32"

    @property
    def wire_bytes(self) -> float:
        """Per-worker bytes of the bandwidth-optimal algorithm: all-reduce
        2p(n-1)/n; all-gather p(n-1); reduce-scatter / all-to-all p(n-1)/n;
        ppermute p."""
        p, n = self.payload_bytes, max(self.n_workers, 1)
        if n == 1:
            return 0.0
        if self.kind in ("psum", "pmax"):
            return 2.0 * p * (n - 1) / n
        if self.kind == "all_gather":
            return float(p * (n - 1))
        if self.kind in ("reduce_scatter", "all_to_all"):
            return p * (n - 1) / n
        return float(p)


@dataclass
class CommLog:
    records: list[CollRecord] = field(default_factory=list)

    def total_bytes(self, kinds: tuple[str, ...] | None = None) -> float:
        return sum(r.wire_bytes * r.mult for r in self.records
                   if kinds is None or r.kind in kinds)

    def payload_bytes(self) -> float:
        return sum(r.payload_bytes * r.mult for r in self.records)

    def by_tag(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for r in self.records:
            key = r.tag or "untagged"
            out[key] = out.get(key, 0.0) + r.wire_bytes * r.mult
        return out

    def by_wire_format(self, *, payload: bool = False,
                       exclude_tags: tuple[str, ...] = ()) -> dict[str, float]:
        out: dict[str, float] = {}
        for r in self.records:
            if r.tag in exclude_tags:
                continue
            b = r.payload_bytes if payload else r.wire_bytes
            out[r.wire_format] = out.get(r.wire_format, 0.0) + b * r.mult
        return out

    def by_axes(self, tag: str | None = None) -> dict[tuple[str, ...], float]:
        """Wire bytes per reduced axes tuple, of the records tagged ``tag``
        (every record if None)."""
        out: dict[tuple[str, ...], float] = {}
        for r in self.records:
            if tag is None or (r.tag or "untagged") == tag:
                out[r.axes] = out.get(r.axes, 0.0) + r.wire_bytes * r.mult
        return out


def _log() -> CommLog | None:
    return getattr(_STATE, "log", None)


def context() -> dict:
    """A snapshot of this thread's booking state (capture, loop, muted, tag,
    axes, wire format, rank group), for :func:`entered` on another thread."""
    return dict(vars(_STATE))


@contextlib.contextmanager
def entered(ctx: dict):
    """Run inside under the booking state ``ctx`` (:func:`context`), on any
    thread; the thread's own state comes back after."""
    prev = dict(vars(_STATE))
    vars(_STATE).clear()
    vars(_STATE).update(ctx, closed=False)
    try:
        yield
    finally:
        vars(_STATE).clear()
        vars(_STATE).update(prev)


def closed():
    """Book nothing on this thread inside: a record it would append raises
    ``RuntimeError`` (while another thread runs the rounds under this
    thread's capture)."""
    return _setting("closed", True)


@contextlib.contextmanager
def capture():
    """Collect the records of collectives issued under this context."""
    prev = _log()
    _STATE.log = CommLog()
    try:
        yield _STATE.log
    finally:
        _STATE.log = prev


class _setting:
    """Set one field of the thread's booking state inside the context (a
    class, so one object can be entered again: a recomputed block's
    context)."""

    def __init__(self, name: str, value):
        self.name, self.value, self.prev = name, value, []

    def __enter__(self):
        self.prev.append(getattr(_STATE, self.name, ""))
        setattr(_STATE, self.name, self.value)

    def __exit__(self, *exc):
        setattr(_STATE, self.name, self.prev.pop())


def tag(name: str):
    return _setting("tag", name)


def over(axes: tuple[str, ...]):
    """Label the collectives issued inside as reducing over mesh ``axes``."""
    return _setting("axes", tuple(axes))


@contextlib.contextmanager
def loop(n: int):
    """Multiply the records issued inside by ``n`` (nested loops multiply)."""
    prev = getattr(_STATE, "mult", 1.0)
    _STATE.mult = prev * n
    try:
        yield
    finally:
        _STATE.mult = prev


def muted(on: bool = True):
    """Book nothing inside (when ``on``; off, an enclosing ``muted`` still
    holds)."""
    return _setting("muted", bool(on) or getattr(_STATE, "muted", False))


def ranks(group):
    """Run the stacked collectives issued inside over ``group``'s processes
    (a :class:`repro_torch.core.ranks.RankGroup`; None: stacked)."""
    return _setting("ranks", group)


def active_group():
    """The rank group of the enclosing :func:`ranks` (None: stacked)."""
    return getattr(_STATE, "ranks", None) or None


def layout(stack: torch.Tensor):
    """(group, W, first worker) of a per-worker stack this process holds:
    stacked, all W rows; under a rank group the rank's own W/R rows, and
    the group to send to (None when it is one rank, with no other)."""
    group = active_group()
    if group is None:
        return None, stack.shape[0], 0
    if stack.shape[0] != group.per_rank:
        raise ValueError(f"a rank holds its {group.per_rank} workers' rows, got "
                         f"{tuple(stack.shape)}")
    return (group if group.world > 1 else None), group.n_workers, group.lo


def own_workers(n_workers: int) -> range:
    """The workers of ``n_workers`` whose rows this process holds: all
    stacked, the rank's own under a rank group."""
    group = active_group()
    return range(n_workers) if group is None else group.workers


def worker_stack(own: torch.Tensor) -> torch.Tensor:
    """A (W, ...) stack of which this process wrote its own workers' rows
    ``own`` (all W stacked: ``own`` itself; under a rank group the other
    ranks' rows NaN, or unset for a non-float dtype, until a collective
    such as :func:`psum` moves them in)."""
    group = active_group()
    if group is None:
        return own
    if own.shape[0] != group.per_rank:
        raise ValueError(f"a rank holds its {group.per_rank} workers' rows, got "
                         f"{tuple(own.shape)}")
    shape = (group.n_workers,) + tuple(own.shape[1:])
    out = (torch.full(shape, float("nan"), dtype=own.dtype, device=own.device)
           if own.is_floating_point() else torch.empty(shape, dtype=own.dtype, device=own.device))
    out[group.lo:group.hi] = own
    return out


def fill_rows(stacked: torch.Tensor) -> torch.Tensor:
    """Under a rank group, the other ranks' rows of a (W, ...) stack moved
    in place, unbooked (the caller books its own records, as the ring and
    rhd hops do); stacked, the identity."""
    group = active_group()
    return stacked if group is None else group.fill_rows(stacked)


def reduce_partial(local_sum: torch.Tensor) -> torch.Tensor:
    """A running sum over this rank's workers made the sum over all W (the
    ranks' partials added in rank order, in their dtype), unbooked: the
    caller booked the psum.  Stacked, the identity."""
    group = active_group()
    return local_sum if group is None else group.sum_partials(local_sum)


def wire_format(name: str):
    """Override the recorded on-wire encoding for collectives issued inside."""
    return _setting("wire_fmt", name)


_DTYPE_FMT = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int8: "int8", torch.uint8: "int8", torch.int32: "int32",
}

WORKER_AXES = ("data",)


def _bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _record(kind: str, local: torch.Tensor, n: int) -> None:
    log = _log()
    if log is None or getattr(_STATE, "muted", False):
        return
    if getattr(_STATE, "closed", False):
        raise RuntimeError(f"a {kind} booked on a thread whose capture another thread is "
                           "booking into (a pipelined step's rounds are in flight)")
    fmt = getattr(_STATE, "wire_fmt", "") or _DTYPE_FMT.get(local.dtype, str(local.dtype))
    log.records.append(CollRecord(kind, getattr(_STATE, "axes", "") or WORKER_AXES,
                                  _bytes(local), getattr(_STATE, "mult", 1.0), n,
                                  getattr(_STATE, "tag", ""), fmt))


def psum(stacked: torch.Tensor) -> torch.Tensor:
    """All-reduce sum of a (W, ...) stack over the worker axis."""
    _record("psum", stacked[0], stacked.shape[0])
    return torch.sum(fill_rows(stacked), dim=0)


def pmean(stacked: torch.Tensor) -> torch.Tensor:
    _record("psum", stacked[0], stacked.shape[0])
    return torch.mean(fill_rows(stacked), dim=0)


def book_psum(local: torch.Tensor, n_workers: int) -> None:
    """Book an all-reduce whose sum the caller accumulates itself (one
    worker's payload at a time, so the W-way stack never exists)."""
    _record("psum", local, n_workers)


def book_all_gather(local: torch.Tensor, n_workers: int) -> None:
    """Book an all-gather whose per-worker payloads the caller keeps itself."""
    _record("all_gather", local, n_workers)


def book_ppermute(local: torch.Tensor, n_workers: int) -> None:
    """Book one neighbour exchange of ``local`` (one worker's hop payload)
    by every worker of a W-way schedule (``repro_torch.core.collectives``)."""
    _record("ppermute", local, n_workers)


MODEL_AXES = ("model",)


def model_psum(partials: torch.Tensor) -> torch.Tensor:
    """All-reduce sum of the M shards' partials, a (M, ...) stack, over the
    model axis (the row-parallel reductions); booked as one shard's
    operand over ``("model",)``."""
    with over(MODEL_AXES):
        _record("psum", partials[0], partials.shape[0])
    return torch.sum(partials, dim=0)


def book_model(kind: str, local: torch.Tensor, msize: int) -> None:
    """Book a model-axis collective of one shard's operand ``local`` whose
    result the caller computes itself (a vocab-parallel lookup or loss term
    computed on the global vocabulary at once)."""
    with over(MODEL_AXES):
        _record(kind, local, msize)


def ppermute(stacked: torch.Tensor, shift: int) -> torch.Tensor:
    """Ring exchange over the worker axis: worker i receives worker
    (i - shift) mod W's row (shift 1 is the reference's "right" permutation
    j -> j + 1, shift -1 its "left" one); books one ``ppermute`` of one
    worker's row.  Under a rank group ``stacked`` is the rank's own rows and
    so is the result: only the |shift| boundary rows a direction cross to
    the neighbour rank (tag 1 rightward, 2 leftward), as their bytes."""
    group, W, _ = layout(stacked)
    _record("ppermute", stacked[0], W)
    if group is None:
        return torch.roll(stacked, shift, 0)
    return group.shift_rows(stacked, shift, 1 if shift > 0 else 2)


def all_gather(stacked: torch.Tensor) -> torch.Tensor:
    """All-gather over the worker axis: the (W, ...) stack already is the
    gathered array (under a rank group once the other ranks' rows are
    moved in); book one worker's slice."""
    _record("all_gather", stacked[0], stacked.shape[0])
    return fill_rows(stacked)


def all_gather_compressed(payload: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """All-gather a stacked wire payload leaf by leaf, each booked at its
    own dtype width (an int8 code array books n bytes, not 4n)."""
    return {k: all_gather(v) for k, v in payload.items()}


def widening_psum(stacked: torch.Tensor) -> torch.Tensor:
    """All-reduce with a narrow wire dtype and f32 accumulation: the (W, ...)
    narrow stack is all-gathered (booked at its own width), then widened and
    summed in worker order, so partial sums are never rounded to the wire
    dtype.  p(n-1) on the wire against a psum's 2p(n-1)/n."""
    all_gather(stacked)
    acc = torch.zeros(stacked.shape[1:], dtype=torch.float32, device=stacked.device)
    for row in stacked:  # worker order; each row widened exactly
        acc.add_(row)
    return acc
