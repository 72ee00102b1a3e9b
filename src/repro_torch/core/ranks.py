"""Ranks on the data axis: the W workers spread over R ``torch.distributed``
processes (the counterpart of the reference's ``data`` mesh axis,
``repro.launch.mesh``, under ``shard_map``).

Rank r holds workers ``[r W/R, (r + 1) W/R)`` as its local stack; the
stacked collectives of :mod:`repro_torch.core.comms` move the other ranks'
rows for real while a :class:`RankGroup` is active (``comms.ranks``).  Two
transports: the backend's all-gather of contiguous blocks (and a barrier),
for the gathered routes (a sum of partials gathers them and adds them in
rank order, so every rank holds the same bits); and point-to-point
messages to named peer ranks (:meth:`RankGroup.sendrecv`), for the hops of
the ring exchange, the ring and rhd all-reduces and the gossip neighbours,
each message under its own tag (at R = 2 the left and the right neighbour
are one rank).  Blocks travel as their raw bytes (uint8), so no dtype needs
the backend's support (gloo on the CPU has bf16 but no int16); a tensor on
the card is staged through a pinned host buffer, explicitly and counted,
and the computation never leaves the card.

The transport blocks the thread that calls it (a card tensor's staging
waits for the calling thread's stream, the backend's calls wait on the
host), so the pipelined step runs its rounds on a communication thread of
their own; while they are in flight that thread owns the transport
(:meth:`RankGroup.owned_by`: a call from another thread raises), and
:attr:`RankStats.exposed_s` counts the seconds the step's main thread
waited for them.

gloo only: NCCL refuses two ranks on one card, and a machine with several
cards is a later slice (``ROADMAP.md`` Queue 1).

    python -m repro_torch.launch.train ... --ranks R     # starts R processes
    torchrun --nproc-per-node R -m repro_torch.launch.train ... --ranks R
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

#: the environment a rank process reads: its rank, the world, and the file
#: store our launcher made (``torchrun`` sets MASTER_ADDR / MASTER_PORT instead)
RANK_ENV, WORLD_ENV, STORE_ENV = "RANK", "WORLD_SIZE", "REPRO_RANKS_STORE"


@dataclass
class RankStats:
    """What one rank really moved: bytes sent and received through the
    backend, host seconds inside ``torch.distributed`` calls and their
    number (an all-gather, or one batch of point-to-point messages), on
    whichever thread made them, and the staging of card tensors through
    pinned host buffers (bytes copied each way, seconds of the copies, and
    seconds waiting for the card's queued work before a copy).
    ``exposed_s``: host seconds the step's main thread spent waiting for a
    round run on the communication thread (the pipelined step), the share
    of the exchange the computation did not hide.  One thread updates the
    stats at a time (:meth:`RankGroup.owned_by`)."""

    sent: int = 0
    received: int = 0
    dist_s: float = 0.0
    calls: int = 0
    staged: int = 0
    stage_s: float = 0.0
    wait_s: float = 0.0
    exposed_s: float = 0.0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


@dataclass
class RankGroup:
    """Rank ``rank`` of ``world`` processes (the default process group)
    over ``n_workers`` workers, its tensors on ``device``."""

    world: int
    rank: int
    n_workers: int
    device: torch.device
    stats: RankStats = field(default_factory=RankStats)
    #: the thread that owns the transport while a pipelined step's rounds
    #: are in flight (None: whichever thread calls)
    _owner: int | None = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.n_workers % self.world:
            raise ValueError(f"{self.n_workers} workers do not split over {self.world} ranks")

    @property
    def per_rank(self) -> int:
        return self.n_workers // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.per_rank

    @property
    def hi(self) -> int:
        return self.lo + self.per_rank

    @property
    def workers(self) -> range:
        return range(self.lo, self.hi)

    # ---- the transport ------------------------------------------------------------

    @contextlib.contextmanager
    def owned_by(self, ident: int):
        """Only thread ``ident`` may use the transport inside: two threads
        issuing collectives in different orders on two ranks would wait for
        each other until the group's timeout, so a call from any other
        thread raises ``RuntimeError`` instead."""
        prev, self._owner = self._owner, ident
        try:
            yield
        finally:
            self._owner = prev

    def _check_owner(self) -> None:
        if self._owner is not None and self._owner != threading.get_ident():
            raise RuntimeError(f"rank {self.rank}: thread {threading.get_ident()} used the "
                               f"transport that thread {self._owner} owns while a pipelined "
                               "step's rounds are in flight")

    def _call(self, fn, *args):
        """One ``torch.distributed`` call (an all-gather, or a batch of
        point-to-point messages waited for), counted: host seconds and
        calls."""
        self._check_owner()
        t0 = time.perf_counter()
        out = fn(*args)
        self.stats.dist_s += time.perf_counter() - t0
        self.stats.calls += 1
        return out

    def _host_bytes(self, blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each block's raw bytes as a flat uint8 tensor the backend can
        send: a host block's own bytes, a card block's copied into a pinned
        host buffer once the card's queued work is done (counted)."""
        srcs = [b.detach().contiguous().reshape(-1).view(torch.uint8) for b in blocks]
        if not any(s.is_cuda for s in srcs):
            return srcs
        st = self.stats
        t0 = time.perf_counter()
        torch.cuda.current_stream(srcs[0].device).synchronize()
        t1 = time.perf_counter()
        hosts = []
        for s in srcs:  # gloo moves host memory: stage through pinned buffers
            host = torch.empty(s.numel(), dtype=torch.uint8, pin_memory=True)
            host.copy_(s)
            st.staged += s.numel()
            hosts.append(host)
        st.wait_s += t1 - t0
        st.stage_s += time.perf_counter() - t1
        return hosts

    def _exchange(self, block: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``block`` (equal shapes and dtypes), in rank order,
        as flat uint8 host tensors (this rank's own entry is ``block``'s
        bytes)."""
        import torch.distributed as dist

        self._check_owner()
        (src,) = self._host_bytes([block])
        st = self.stats
        outs = [torch.empty(src.numel(), dtype=torch.uint8, pin_memory=block.is_cuda)
                for _ in range(self.world)]
        self._call(dist.all_gather, outs, src)  # src is not any of outs
        st.sent += src.numel() * (self.world - 1)
        st.received += src.numel() * (self.world - 1)
        return outs

    def _into(self, dst: torch.Tensor, raw: torch.Tensor) -> None:
        """Copy one rank's raw bytes into ``dst`` (any strides, any device)."""
        t0 = time.perf_counter()
        dst.copy_(raw.view(dst.dtype).view(dst.shape))
        if dst.is_cuda:
            self.stats.stage_s += time.perf_counter() - t0
            self.stats.staged += raw.numel()

    def sendrecv(self, sends: list[tuple[int, int, torch.Tensor]],
                 recvs: list[tuple[int, int, torch.Tensor]]) -> None:
        """Point-to-point messages: each ``(peer, tag, block)`` of ``sends``
        goes to rank ``peer``, and each ``(peer, tag, dst)`` of ``recvs`` is
        received from rank ``peer`` into ``dst`` (its raw bytes; any strides,
        any device).  Every send is posted with every receive in one
        ``batch_isend_irecv`` and all are waited for; a peer's message pairs
        with the receive of the same tag, so two messages between one pair of
        ranks in one call need two tags."""
        import torch.distributed as dist

        if not sends and not recvs:
            return
        self._check_owner()
        st = self.stats
        srcs = self._host_bytes([b for _, _, b in sends])
        ops, raws = [], []
        for (peer, tag, _), src in zip(sends, srcs):
            ops.append(dist.P2POp(dist.isend, src, peer, tag=tag))
            st.sent += src.numel()
        for peer, tag, dst in recvs:
            raw = torch.empty(dst.numel() * dst.element_size(), dtype=torch.uint8,
                              pin_memory=dst.is_cuda)
            ops.append(dist.P2POp(dist.irecv, raw, peer, tag=tag))
            raws.append(raw)
            st.received += raw.numel()
        self._call(_post_and_wait, ops)
        for (_, _, dst), raw in zip(recvs, raws):
            self._into(dst, raw)

    def shift_rows(self, local: torch.Tensor, shift: int, tag: int) -> torch.Tensor:
        """The ring exchange over the ranks: this rank's rows of the (W, ...)
        stack rolled by ``shift`` along the worker axis (worker i receives
        worker (i - shift) mod W's row), from ``local``, its own (W/R, ...)
        rows.  Rows whose source is this rank's are copied; the others come,
        row blocks in worker order, from the ranks that hold them, under
        ``tag``.  Returns a new (W/R, ...) tensor."""
        k, W = self.per_rank, self.n_workers
        out = torch.empty_like(local)
        sends: dict[int, list[int]] = {}
        recvs: dict[int, list[int]] = {}
        for j in range(k):
            src = (self.lo + j - shift) % W
            if src // k == self.rank:
                out[j].copy_(local[src - self.lo])
            else:
                recvs.setdefault(src // k, []).append(j)
            dst = (self.lo + j + shift) % W
            if dst // k != self.rank:
                sends.setdefault(dst // k, []).append(j)
        for js in (*sends.values(), *recvs.values()):  # a peer's rows are one block
            if js != list(range(js[0], js[-1] + 1)):
                raise ValueError(f"shift {shift} over {self.world} ranks splits a row block")
        self.sendrecv([(peer, tag, local[js[0]:js[-1] + 1]) for peer, js in sends.items()],
                      [(peer, tag, out[js[0]:js[-1] + 1]) for peer, js in recvs.items()])
        return out

    def fill_rows(self, stacked: torch.Tensor) -> torch.Tensor:
        """A (W, ...) stack whose rows ``[lo, hi)`` this rank wrote: the
        other ranks' rows written in place from theirs; returns it."""
        if stacked.shape[0] != self.n_workers:
            raise ValueError(f"a rank exchange takes a stack of the {self.n_workers} workers, "
                             f"got {tuple(stacked.shape)}")
        k = self.per_rank
        outs = self._exchange(stacked[self.lo:self.hi])
        for r, raw in enumerate(outs):
            if r != self.rank:
                self._into(stacked[r * k:(r + 1) * k], raw)
        return stacked

    def gather(self, local: torch.Tensor, host: bool = False) -> torch.Tensor:
        """Every rank's ``local``, stacked in rank order: (R, *shape), on
        ``local``'s device, or with ``host`` in host memory, where the other
        ranks' bytes arrive (a checkpoint's arrays go there: the card holds
        no gathered copy)."""
        out = torch.empty((self.world,) + tuple(local.shape), dtype=local.dtype,
                          device="cpu" if host else local.device)
        for r, raw in enumerate(self._exchange(local)):
            if r == self.rank:
                out[r].copy_(local)
            else:
                self._into(out[r], raw)
        return out

    def sum_partials(self, local: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of each rank's partial sum ``local``, added in
        rank order in ``local``'s dtype (so every rank holds the same bits)."""
        parts = self.gather(local)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc.add_(p)
        return acc

    def barrier(self) -> None:
        import torch.distributed as dist

        self._check_owner()
        t0 = time.perf_counter()
        dist.barrier()
        self.stats.dist_s += time.perf_counter() - t0


def _post_and_wait(ops: list) -> None:
    import torch.distributed as dist

    for work in dist.batch_isend_irecv(ops):
        work.wait()


# ---- initialisation ----------------------------------------------------------------

def rank_device(rank: int, device: str | torch.device) -> torch.device:
    """Rank r's device: ``cuda:(r % device_count)`` when ``device`` is the
    card, the CPU only when the caller asks for it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a rank on the card needs a CUDA device; pass --device cpu for the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_group(n_workers: int, device: str | torch.device, *,
               timeout: float = 600.0) -> RankGroup:
    """Join the process group from the environment: ``RANK`` and
    ``WORLD_SIZE``, and a file store at ``REPRO_RANKS_STORE`` (our
    launcher's) or ``MASTER_ADDR`` / ``MASTER_PORT`` (``torchrun``'s).  gloo,
    with ``timeout`` seconds for every collective."""
    import torch.distributed as dist

    rank, world = int(os.environ[RANK_ENV]), int(os.environ[WORLD_ENV])
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend="gloo", rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout))
    if os.environ.get(STORE_ENV):
        dist.init_process_group(store=dist.FileStore(os.environ[STORE_ENV], world), **kw)
    else:
        dist.init_process_group(init_method="env://", **kw)
    return RankGroup(world, rank, n_workers, dev)


def close_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


# ---- the launcher --------------------------------------------------------------------

class RankFailure(RuntimeError):
    """A rank exited non-zero or overran its time limit; the message holds
    every rank's output."""


def _package_root() -> str:
    return str(Path(__file__).resolve().parents[2])


def launch(module: str, args: list[str], world: int, *, timeout: float,
           env: dict | None = None) -> list[str]:
    """Run ``python -m module *args`` as ``world`` rank processes over a
    fresh file store and return each rank's output (stdout and stderr
    joined), in rank order.  Raises :class:`RankFailure`, with every rank's
    output, if any rank fails or the ranks overrun ``timeout`` seconds (all
    are then killed)."""
    tmp = tempfile.mkdtemp(prefix="repro-ranks-")
    root = _package_root()
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = root + (os.pathsep + base["PYTHONPATH"] if base.get("PYTHONPATH")
                                 else "")
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *args], stdout=log, stderr=subprocess.STDOUT,
                env=dict(base, **{RANK_ENV: str(r), WORLD_ENV: str(world), "LOCAL_RANK": str(r),
                                  STORE_ENV: os.path.join(tmp, "store")})))
        deadline, failed = time.monotonic() + timeout, None
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                failed = "a rank failed"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks overran their {timeout:.0f} s"
                break
            time.sleep(0.05)
        for p in procs:  # the rest of a failed group would wait for ever
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
        if failed is None and any(p.returncode for p in procs):
            failed = "a rank failed"
        if failed:
            raise RankFailure(f"{module} over {world} ranks: {failed}; exit codes "
                              f"{[p.returncode for p in procs]}\n" + "\n".join(
                                  f"--- rank {r} ---\n{o}" for r, o in enumerate(outs)))
        return outs
    finally:
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
