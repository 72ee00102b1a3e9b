"""Booked collectives over the stacked worker axis (counterpart of
``repro.core.comms``).

On one card the W data-parallel workers are a leading tensor axis, so a
collective is a stack or a sum over that axis.  Each call still books what
a real n-way collective would move: the local payload of one worker, its
wire format, the mesh axes it reduces over (``over``: ``("data",)`` by
default; ``("pod",)`` or ``("pod", "data")`` on a two-level layout) and n,
their extent, priced by the reference's ``wire_bytes`` formulas, times the
enclosing ``loop`` multiplicity.  Records are kept only inside
``capture()``, and not inside ``muted()``: a program that runs the same
collectives again (the pipelined step's later rounds, every pod's round
but the first) books them once, as the reference traces them once.
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


@contextlib.contextmanager
def capture():
    """Collect the records of collectives issued under this context."""
    prev = _log()
    _STATE.log = CommLog()
    try:
        yield _STATE.log
    finally:
        _STATE.log = prev


@contextlib.contextmanager
def _setting(name: str, value):
    prev = getattr(_STATE, name, "")
    setattr(_STATE, name, value)
    try:
        yield
    finally:
        setattr(_STATE, name, prev)


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
    """Book nothing inside (when ``on``)."""
    return _setting("muted", bool(on))


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
    fmt = getattr(_STATE, "wire_fmt", "") or _DTYPE_FMT.get(local.dtype, str(local.dtype))
    log.records.append(CollRecord(kind, getattr(_STATE, "axes", "") or WORKER_AXES,
                                  _bytes(local), getattr(_STATE, "mult", 1.0), n,
                                  getattr(_STATE, "tag", ""), fmt))


def psum(stacked: torch.Tensor) -> torch.Tensor:
    """All-reduce sum of a (W, ...) stack over the worker axis."""
    _record("psum", stacked[0], stacked.shape[0])
    return torch.sum(stacked, dim=0)


def pmean(stacked: torch.Tensor) -> torch.Tensor:
    _record("psum", stacked[0], stacked.shape[0])
    return torch.mean(stacked, dim=0)


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


def ppermute(stacked: torch.Tensor, shift: int) -> torch.Tensor:
    """Ring exchange over the worker axis: worker i receives worker
    (i - shift) mod W's row (shift 1 is the reference's "right" permutation
    j -> j + 1, shift -1 its "left" one); books one ``ppermute`` of one
    worker's row."""
    _record("ppermute", stacked[0], stacked.shape[0])
    return torch.roll(stacked, shift, 0)


def all_gather(stacked: torch.Tensor) -> torch.Tensor:
    """All-gather over the worker axis: the (W, ...) stack already is the
    gathered array; book one worker's slice."""
    _record("all_gather", stacked[0], stacked.shape[0])
    return stacked


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
