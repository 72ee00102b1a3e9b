"""Bucketed gradient aggregation over W stacked workers (counterpart of
``repro.core.aggregate``).

    u = m*u + g;  a = clip(u) + e*decay;  c = C(a);  e = a - C(a);
    agg = Aggregate(c_1..W)

On one card the W data-parallel workers are a leading tensor axis, so a
round is split in two halves.  :meth:`AggregationRound.add` is one worker's
send side: ``feedback.pre_compress`` and compression of each bucket, the
wire payload written straight into that worker's row of the round's wire
stack, and ``feedback.post_compress``.  :meth:`AggregationRound.finish` is
the receive side: the booked collective and the reduction of each bucket.
The trainer calls ``add`` right after each worker's backward, so W full f32
gradients never live at once; :func:`aggregate_buckets` runs both halves
over already-stacked (W, n) gradients.  :class:`GroupedRound` runs one
round per pod of a two-level layout, each over that pod's D workers, and
:class:`ShardedRound` one such round per shard of the model axis, each over
the W workers' shard-local buckets.

The reductions, per bucket (:func:`bucket_route`):

* ``dense``: no compressor, dense wire: an all-reduce of ``a`` in
  ``agg_dtype`` (f32, or bf16 rounded after every addition as the
  reference's bf16 psum is) by schedule ``collective``: one booked psum
  (``xla``) or the ring / recursive halving-doubling schedules of
  :mod:`repro_torch.core.collectives`, each hop booked as a ``ppermute``;
* ``widen``: no compressor (or a ``"none"`` rule) on the compressed wire:
  the bf16 wire, ``comms.widening_psum`` (a booked bf16 all-gather, then
  an f32 sum in worker order);
* ``powersgd``: the two factor psums of PowerSGD with an orthonormalize
  between them, ``Q`` carried in ``comm_state["psgd_q"]``; error feedback
  is taken against the global approximation, in :meth:`finish`;
* ``fused_ef``: the reference's fused-EF gate (compressed wire, EF on, no
  momentum correction, no local clip, a compressor with ``compress_ef_p``):
  kernels ``qsgd_ef`` then ``int8_acc``, each worker's residual updated in
  place;
* ``int8_acc``: ``_int8_code_reduce`` on the compressed wire (kernel
  ``qsgd`` for ``qsgd_kernel``, plain codes for the ``qsgd`` twin, then
  kernel ``int8_acc``); each row weighs ``norm_w / s_w``, ``s_w`` gathered
  when the payload carries it and the ``levels`` knob otherwise;
* ``sign``: the 1-bit compressed wire (``signsgd_packed``'s mean of votes,
  ``signsgd``'s majority): kernels ``sign_pack`` then ``sign_vote``;
* ``tern``: the 2-bit compressed wire (``terngrad_kernel``, ``terngrad``):
  ternary codes (kernel ``terngrad`` for ``terngrad_kernel``; plain for
  ``terngrad``, as in the reference), kernels ``tern_pack`` then
  ``tern_acc`` with each worker's scale as its weight;
* ``majority``: ``signsgd`` on the dense wire: a booked int8 psum of the
  signs, ties to +1;
* ``gather``: ``reduce_mode="none"`` on the dense wire: every payload leaf
  all-gathered at its dtype width in payload order, then decoded and summed
  in worker order (``signsgd_packed`` decodes with kernel ``sign_unpack``);
  a sparse ``(values, indices)`` payload (the top-k family) is instead
  scatter-added into an f32 zero vector, one worker row at a time;
* ``sum``: ``reduce_mode="sum"`` (the threshold family, ``wangni``,
  ``variance_sparse``): each worker's masked dense payload accumulated, a
  psum of its f32 ``dense`` leaf alone booked (kernel ``threshold`` masks
  for ``threshold`` and ``adaptive_threshold``).

gTop-k's ``re_sparsify`` then keeps the k largest magnitudes of the mean.

Churn and integrity (:class:`Liveness`, the reference's masked program):
a round carries each worker's participation bit ``alive`` and, in the
integrity program, its corruption flag.  Every worker still compresses
every bucket; the mask selects afterwards.  A rejoiner's EF and momentum
rows reset before the round; a masked or quarantined worker's rows freeze.
A flagged worker's wire payload is corrupted in its own domain after
compression (its EF works against the clean one), each row is validated
with the redundancy its format has (:mod:`repro_torch.core.integrity`), and
an invalid row is selected out of the reduction for the round.  Alive times
validity enters the reductions only through the weights the wire kernels
already take (``int8_acc``, ``sign_vote``, ``tern_acc``), or as a select on
the psum and gather routes; the mean divides by the live (and valid) count
``n_eff`` (a booked scalar psum, or the gathered bits), so a churn round
launches exactly the kernels of its churn-free twin.  After the buckets,
``quarantine_limit`` consecutive quarantined rounds escalate: the worker's
EF and momentum rows reset, and ``qcount``, ``quarantine_total`` and
``escalation_total`` keep the tallies (one entry per worker).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core import collectives, comms, feedback, integrity
from repro_torch.core.compression.base import (
    Compressed,
    compress_p,
    decompress_p,
    get_compressor,
    needs_noise,
    noise_len,
    runtime_knob_values,
    runtime_knobs,
)
from repro_torch.core.compression.powersgd import (
    matmul_rows,
    matmul_rows_t,
    orthonormalize,
    shape2d,
)
from repro_torch.core.compression.sparsification import k_of, top_k
from repro_torch.core.types import CommConfig, churn_enabled, effective_corruption_kind
from repro_torch.kernels import ops
from repro_torch.utils.tree import flatten_with_paths

f32 = torch.float32

#: noise(step, worker, bucket, n[, round]) -> (n,) f32 uniform draws in
#: [0, 1); worker is None for a draw every worker shares (CHOCO-SGD's
#: round); ``round`` is passed only by the pipelined step's rounds (the
#: reference folds the round index into the step's key before the worker)
Noise = Callable[..., torch.Tensor]

#: churn_draws(step, worker[, round]) -> (u_mask, u_corrupt), two 0-dim f32
#: uniform draws in [0, 1) on the device: the worker's participation draw
#: and its corruption draw (the reference's 0x6368 and CORRUPT_FOLD folds of
#: the worker's key); worker is the index over every data axis (pod-local
#: SGD included), ``round`` a pipelined round's index
ChurnDraws = Callable[..., tuple]


@dataclass(frozen=True)
class Bucket:
    name: str
    #: (leaf_index, size) segments concatenated into this bucket
    segments: tuple[tuple[int, int], ...]
    size: int
    compressor_name: str
    compressor_kwargs: tuple  # hashable kv pairs


@dataclass(frozen=True)
class BucketPlan:
    buckets: tuple[Bucket, ...]

    def compressor(self, b: Bucket):
        return get_compressor(b.compressor_name, **dict(b.compressor_kwargs))

    def knob_values(self) -> tuple[dict, ...]:
        """Per-bucket runtime compressor knob values (qsgd levels)."""
        return tuple(runtime_knob_values(self.compressor(b)) for b in self.buckets)


def plan_signature(plan: BucketPlan) -> tuple:
    """Structural identity of a plan: segment layout plus the compressor
    family per bucket, runtime knob values removed."""
    out = []
    for b in plan.buckets:
        traced = set(runtime_knobs(plan.compressor(b)))
        static_kw = tuple(kv for kv in b.compressor_kwargs if kv[0] not in traced)
        out.append((b.name, b.segments, b.size, b.compressor_name, static_kw))
    return tuple(out)


def _rule_for(comm: CommConfig, path: str) -> tuple[str, dict]:
    for sub, name, kwargs in comm.per_tensor_rules:
        if sub in path:
            return name, kwargs
    return comm.compressor, dict(comm.compressor_kwargs)


def make_bucket_plan(comm: CommConfig, grads_abstract: Any) -> BucketPlan:
    """Static bucketing from leaf shapes (any tree whose leaves have
    ``.shape``).  As in the reference, buckets follow the sorted path order
    and segment indices count positions in that order."""
    items = sorted(flatten_with_paths(grads_abstract).items())
    buckets: list[Bucket] = []
    if comm.bucket_mb <= 0:
        for i, (path, leaf) in enumerate(items):
            name, kw = _rule_for(comm, path)
            n = int(np.prod(leaf.shape))
            buckets.append(Bucket(path, ((i, n),), n, name, tuple(sorted(kw.items()))))
    else:
        cap = int(comm.bucket_mb * 1024 * 1024 / 4)
        kw = tuple(sorted(comm.compressor_kwargs.items()))
        cur: list[tuple[int, int]] = []
        cur_size = 0
        for i, (path, leaf) in enumerate(items):
            n = int(np.prod(leaf.shape))
            if cur and cur_size + n > cap:
                buckets.append(Bucket(f"bucket{len(buckets)}", tuple(cur), cur_size,
                                      comm.compressor, kw))
                cur, cur_size = [], 0
            cur.append((i, n))
            cur_size += n
        if cur:
            buckets.append(Bucket(f"bucket{len(buckets)}", tuple(cur), cur_size,
                                  comm.compressor, kw))
    return BucketPlan(tuple(buckets))


def init_comm_state(comm: CommConfig, plan: BucketPlan, n_workers: int,
                    device: str | torch.device, pods: int = 1,
                    shards: int = 1) -> dict[str, Any]:
    """Communication state of W workers: ``ef[i]`` and ``u[i]`` are the
    (W, size) stacks of bucket i's EF residuals and momentum buffers, one
    row per worker (``ef[i]`` is None for a bucket without a compressor).
    A plan with a ``powersgd`` bucket adds ``psgd_q[i]``, that bucket's
    flat (b * rank,) f32 factor Q, shared by every worker: a standard
    normal draw from a torch generator seeded with 1000 + i (the reference
    draws it from ``jax.random.key(1000 + i)``), and an empty tensor for
    the other buckets.  CHOCO-SGD gossip adds ``choco_xhat[i]`` and
    ``choco_nbr[i]``, (W, size) f32 zero stacks (the EF and momentum stacks
    are allocated as the reference allocates them, though a gossip step
    reads neither).  Pipelined overlap with staleness 1 adds
    ``overlap_pending[i]``, the (W, size) f32 bucket gradients of each
    worker's last microbatch, which the next step aggregates first (zeros
    before the first step; allocated for a gossip cell too, as there).

    Churn adds ``alive_prev`` (W,) f32 ones, each worker's bit of the
    previous round (and ``pod_alive_prev`` under pod-local SGD, each
    worker's copy of its pod's bit of the previous sync); the integrity
    program adds ``qcount``, ``quarantine_total`` and ``escalation_total``,
    (W,) f32 zeros.  Under pod-local SGD over ``pods`` > 1 pods each pod
    carries its own PowerSGD Q: ``psgd_q[i]`` is then (pods, b * rank).

    Over ``shards`` M > 1 model shards (``plan`` then holds the shard-local
    buckets) every per-worker stack has one row per (worker, shard), W * M
    rows in the reference's device order (row w * M + m); the churn and
    PowerSGD entries do not run under the model axis yet."""
    rows = n_workers * shards
    state: dict[str, Any] = {"step": 0}
    if churn_enabled(comm):
        state["alive_prev"] = torch.ones(n_workers, dtype=f32, device=device)
        if comm.pod_local:
            state["pod_alive_prev"] = torch.ones(n_workers, dtype=f32, device=device)
    if effective_corruption_kind(comm) != "none":
        for k in ("qcount", "quarantine_total", "escalation_total"):
            state[k] = torch.zeros(n_workers, dtype=f32, device=device)
    if comm.error_feedback:
        state["ef"] = [torch.zeros((rows, b.size), dtype=f32, device=device)
                       if plan.compressor(b) is not None else None for b in plan.buckets]
    if comm.momentum_correction:
        state["u"] = [torch.zeros((rows, b.size), dtype=f32, device=device)
                      for b in plan.buckets]
    if any(b.compressor_name == "powersgd" for b in plan.buckets):
        groups = pods if comm.pod_local and pods > 1 else 0
        state["psgd_q"] = []
        for i, b in enumerate(plan.buckets):
            q = (plan.compressor(b).init_q(b.size, 1000 + i, device).reshape(-1)
                 if b.compressor_name == "powersgd" else torch.zeros(0, dtype=f32, device=device))
            state["psgd_q"].append(torch.stack([q] * groups) if groups else q)
    if comm.overlap == "pipelined" and comm.overlap_staleness == 1:
        state["overlap_pending"] = [torch.zeros((rows, b.size), dtype=f32, device=device)
                                    for b in plan.buckets]
    if comm.aggregator == "gossip" and comm.gossip_compress == "choco":
        for k in ("choco_xhat", "choco_nbr"):
            state[k] = [torch.zeros((rows, b.size), dtype=f32, device=device)
                        for b in plan.buckets]
    return state


#: the per-worker (rows, size) comm-state stacks, one per bucket
COMM_STACKS = ("ef", "u", "choco_xhat", "choco_nbr", "overlap_pending")


def shard_view(comm_state: dict[str, Any], m: int, shards: int) -> dict[str, Any]:
    """Model shard m's comm state: each (W * M, size) stack cut to its W
    rows w * M + m (views: in-place updates reach the whole).  ``step`` is
    a copy: the caller advances the whole state's."""
    if shards == 1:
        return comm_state
    view = dict(comm_state)
    for k in COMM_STACKS:
        if k in view:
            view[k] = [None if e is None else e.view(-1, shards, e.shape[1])[:, m]
                       for e in view[k]]
    return view


def gather_bucket(b: Bucket, leaves: list[torch.Tensor]) -> torch.Tensor:
    """One bucket's flat f32 vector from its leaves (f32 widening)."""
    parts = [leaves[i].reshape(-1).to(f32) for i, _ in b.segments]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _gather_buckets(plan: BucketPlan, leaves: list[torch.Tensor]) -> list[torch.Tensor]:
    return [gather_bucket(b, leaves) for b in plan.buckets]


def _scatter_buckets(plan: BucketPlan, bucket_vals: list[torch.Tensor],
                     leaves_like: list[torch.Tensor]) -> list[torch.Tensor]:
    new = list(leaves_like)
    for b, v in zip(plan.buckets, bucket_vals):
        off = 0
        for i, n in b.segments:
            new[i] = v[off:off + n].reshape(leaves_like[i].shape).to(leaves_like[i].dtype)
            off += n
    return new


def seeded_noise(seed: int, device: str | torch.device) -> Noise:
    """Default noise: uniform draws from a ``torch.Generator`` on ``device``
    seeded from (seed, step, worker, bucket), so any round of any worker can
    be redrawn alone (a pipelined round's index joins the step's).  On the
    shape-only ``meta`` device it allocates only."""
    device = torch.device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device)

    def noise(step: int, worker: int, bucket: int, n: int, rnd: int | None = None
              ) -> torch.Tensor:
        if gen is None:
            return torch.empty(n, dtype=f32, device=device)
        at = step if rnd is None else f"{step}.{rnd}"
        digest = hashlib.blake2b(f"{seed}/{at}/{worker}/{bucket}".encode(),
                                 digest_size=8).digest()
        gen.manual_seed(int.from_bytes(digest, "little") >> 1)
        return torch.rand(n, generator=gen, dtype=f32, device=device)

    return noise


def seeded_churn_draws(seed: int, device: str | torch.device) -> ChurnDraws:
    """Default churn draws: two uniforms from a ``torch.Generator`` on
    ``device`` seeded from (seed, step, worker, round), so any worker's draw
    can be redrawn alone; shape-only on ``meta``."""
    device = torch.device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device)

    def draws(step: int, worker: int, rnd: int | None = None):
        if gen is None:
            u = torch.empty(2, dtype=f32, device=device)
        else:
            at = step if rnd is None else f"{step}.{rnd}"
            digest = hashlib.blake2b(f"churn/{seed}/{at}/{worker}".encode(),
                                     digest_size=8).digest()
            gen.manual_seed(int.from_bytes(digest, "little") >> 1)
            u = torch.rand(2, generator=gen, dtype=f32, device=device)
        return u[0], u[1]

    return draws


@dataclass
class Liveness:
    """One round's churn draws over its workers: ``alive`` and
    ``rejoined`` (W,) 0/1 f32, and in the integrity program the corruption
    ``flag`` (W,) of the payloads and their ``kind``.  :meth:`rows` cuts
    the workers of one pod."""

    alive: torch.Tensor
    rejoined: torch.Tensor | None = None  # None: nobody rejoins this round
    flag: torch.Tensor | None = None
    kind: str = "none"

    def rows(self, lo: int, hi: int) -> "Liveness":
        cut = (lambda t: None if t is None else t[lo:hi])
        return Liveness(self.alive[lo:hi], cut(self.rejoined), cut(self.flag), self.kind)


def in_window(comm: CommConfig, step: int) -> bool:
    """Is ``step`` inside the churn window [churn_start, churn_end)?"""
    return comm.churn_start <= step and (comm.churn_end < 0 or step < comm.churn_end)


def draw_uniforms(churn_draws: ChurnDraws, step: int, workers: range, rnd: int | None,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (W,) mask and corruption uniforms of ``workers``."""
    got = [churn_draws(step, w, rnd) for w in workers]
    return (torch.stack([g[0] for g in got]).to(device=device, dtype=f32),
            torch.stack([g[1] for g in got]).to(device=device, dtype=f32))


def churn_mask(comm: CommConfig, u_mask: torch.Tensor, window: bool,
               workers: range) -> torch.Tensor:
    """Each worker's participation bit: 0 inside the window where its draw
    falls below its dropout rate (``worker_dropout[w]``, else
    ``dropout_rate``)."""
    if not window:
        return torch.ones_like(u_mask)
    dev = u_mask.device  # filled there: a host-to-card copy would wait for the card
    if comm.worker_dropout:
        drop = torch.stack([torch.full((), float(comm.worker_dropout[w]), dtype=f32,
                                       device=dev) for w in workers])
    else:
        drop = torch.full((len(workers),), float(comm.dropout_rate), dtype=f32, device=dev)
    return torch.where(u_mask < drop, 0.0, 1.0)


def corruption_flags(comm: CommConfig, u_corrupt: torch.Tensor, alive: torch.Tensor,
                     window: bool) -> torch.Tensor:
    """Each worker's corruption flag: a live in-window worker's draw below
    ``corruption_rate``."""
    gate = (alive > 0) & window
    return integrity.corruption_flag(u_corrupt, comm.corruption_rate, gate)


def draw_mask(comm: CommConfig, comm_state: dict[str, Any], churn_draws: ChurnDraws,
              step: int, window_step: int, n_workers: int, device, rnd: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, bool, torch.Tensor]:
    """Each worker's participation bit from its draw at (step, worker,
    rnd), the window read at ``window_step``; ``rejoined`` against
    ``alive_prev``, which becomes this round's bits.  Returns (alive,
    rejoined, in_window, the corruption uniforms of the same draws)."""
    workers = range(n_workers)
    u_mask, u_corr = draw_uniforms(churn_draws, step, workers, rnd, device)
    window = in_window(comm, window_step)
    alive = churn_mask(comm, u_mask, window, workers)
    prev = comm_state["alive_prev"]
    rejoined = alive * (1.0 - prev)
    prev.copy_(alive)
    return alive, rejoined, window, u_corr


def draw_liveness(comm: CommConfig, comm_state: dict[str, Any], churn_draws: ChurnDraws,
                  step: int, n_workers: int, device, rnd: int | None = None) -> Liveness:
    """The reference's per-round draw (``aggregate_buckets``):
    :func:`draw_mask` with the window read at the comm state's step, and
    the corruption flags in the integrity program."""
    alive, rejoined, window, u_corr = draw_mask(comm, comm_state, churn_draws, step,
                                                comm_state["step"], n_workers, device, rnd)
    kind = effective_corruption_kind(comm)
    flag = corruption_flags(comm, u_corr, alive, window) if kind != "none" else None
    return Liveness(alive, rejoined, flag, kind)


def reset_rows(comm_state: dict[str, Any], rows: torch.Tensor) -> None:
    """Zero the EF and momentum rows of the workers where ``rows`` (W,) is
    set: the rejoin protocol's reset leg."""
    mask = rows[:, None] > 0
    for k in ("ef", "u"):
        for e in comm_state.get(k, ()):
            if e is not None:
                e.masked_fill_(mask, 0.0)


def quarantine_update(comm: CommConfig, comm_state: dict[str, Any], alive: torch.Tensor,
                      valid: torch.Tensor) -> None:
    """Bounded quarantine after a round (``valid`` (W,): each worker's
    payloads all valid): a live worker's consecutive count rises on an
    invalid round and clears on a valid one; at ``quarantine_limit`` it
    escalates into the rejoin reset (EF and momentum rows zeroed, count
    cleared).  The tallies count quarantined rounds and escalations."""
    q = comm_state["qcount"]
    q_new = torch.where(alive > 0, torch.where(valid > 0, 0.0, q + 1.0), q)
    esc = torch.where(q_new >= float(comm.quarantine_limit), 1.0, 0.0)
    reset_rows(comm_state, esc)
    q.copy_(torch.where(esc > 0, 0.0, q_new))
    comm_state["quarantine_total"].add_(1.0 - valid)
    comm_state["escalation_total"].add_(esc)


def _wire_stack(n_workers: int, n: int, device, dtype=torch.int8) -> torch.Tensor:
    """(W, n) wire stack whose rows start on 16-byte boundaries, so the
    kernels can use vector loads and stores on every row."""
    ld = -(-n // 16) * 16
    return torch.empty((n_workers, ld), dtype=dtype, device=device)[:, :n]


def bucket_route(comm: CommConfig, comp) -> str:
    """Which reduction a bucket with compressor ``comp`` takes under
    ``comm`` (the reference's dispatch in ``aggregate_buckets``,
    ``_aggregate_one`` and ``_compressed_reduce``); raises
    ``NotImplementedError`` for a reduction the port does not run."""
    if comp is None:
        return "widen" if comm.wire_format == "compressed" else "dense"
    if getattr(comp, "reduce_mode", "") == "powersgd":
        return "powersgd"
    wr = getattr(comp, "wire_reduce", "") if comm.wire_format == "compressed" else ""
    if wr:  # a compressor without a wire_reduce takes its reduce_mode below
        if (wr == "int8_acc" and comm.error_feedback and not comm.momentum_correction
                and not comm.local_clip and hasattr(comp, "compress_ef_p")):
            return "fused_ef"
        if wr == "int8_acc":
            return "int8_acc"
        if wr in ("sign_acc", "sign_vote"):
            return "sign"
        if wr == "tern_acc":
            return "tern"
        raise NotImplementedError(f"the {wr!r} compressed-wire reduction of {comp.name!r} "
                                  "is not ported")
    mode = comp.reduce_mode
    if mode == "majority":
        return "majority"
    if mode == "none":
        return "gather"
    if mode == "sum":
        return "sum"
    raise NotImplementedError(f"the {mode!r} reduction of {comp.name!r} is not ported")


class AggregationRound:
    """One BSP aggregation round over W stacked workers.

    ``comm_state`` is updated in place (each worker's EF and momentum rows,
    PowerSGD's Q) and returned by :meth:`finish` with ``step`` advanced.
    ``noise`` supplies the uniform draws of the stochastic compressors, for
    step ``step`` (default: the comm state's; the trainer passes its own
    step, which keeps counting through the inner steps of local SGD) and,
    in a pipelined step, round ``rnd``.  ``live`` (churn) holds the round's
    draws; the caller made them (:func:`draw_liveness`, or one mask for a
    whole pipelined step) and reset the rejoiners' rows."""

    def __init__(self, comm: CommConfig, plan: BucketPlan, comm_state: dict[str, Any],
                 n_workers: int, noise: Noise, device: str | torch.device,
                 step: int | None = None, rnd: int | None = None,
                 live: Liveness | None = None):
        self.comm, self.plan, self.state = comm, plan, comm_state
        self.step = comm_state["step"] if step is None else step
        self.rnd = rnd
        self.n_workers, self.noise, self.device = n_workers, noise, torch.device(device)
        self.comps = [plan.compressor(b) for b in plan.buckets]
        self.routes = [bucket_route(comm, comp) for comp in self.comps]
        self.knobs = plan.knob_values()
        if comm.collective == "rhd" and n_workers & (n_workers - 1):
            raise ValueError(f"collective='rhd' requires power-of-two workers, got {n_workers}")
        #: the dense route's wire dtype
        self.dense_dtype = torch.bfloat16 if comm.agg_dtype == "bfloat16" else f32
        nb = len(plan.buckets)
        #: running sums over workers: dense ones (``dense`` under ``xla``,
        #: ``sum``), int8 vote sums (``majority``), or PowerSGD's sum of
        #: M_w @ Q (``powersgd``)
        self._sums: list[torch.Tensor | None] = [None] * nb
        #: (W, ...) stacks: int8 codes (``fused_ef``, ``int8_acc``), packed
        #: sign bytes (``sign``), packed ternary bytes (``tern``), bf16
        #: vectors (``widen``), zero-padded vectors (``dense`` under ``ring``
        #: or ``rhd``) or PowerSGD's inputs a_w without EF or under churn
        #: (``powersgd``)
        self._stacks: list[torch.Tensor | None] = [None] * nb
        #: per-worker f32 scalars by payload leaf, each a (W,) vector: QSGD's
        #: norms (and ``s``), ternary scales
        self._scalars: list[dict[str, torch.Tensor]] = [{} for _ in range(nb)]
        #: per-worker payloads of the ``gather`` route, in worker order
        self._payloads: list[list[dict[str, torch.Tensor]]] = [[] for _ in range(nb)]
        #: kept elements of this round's masked payloads (their ``nnz``
        #: leaves summed over workers and buckets; None without any), and
        #: the elements they were kept from
        self.nnz: torch.Tensor | None = None
        self.nnz_of = 0
        self.live = live
        self.kind = live.kind if live is not None and live.flag is not None else "none"
        #: integrity: each worker's payload validity per bucket, (W,) 0/1
        self._valid = ([torch.ones(n_workers, dtype=f32, device=self.device) for _ in range(nb)]
                       if self.kind != "none" else None)

    def _noise(self, w: int, i: int, n: int) -> torch.Tensor:
        if self.rnd is None:  # the sequential step's chain: (step, worker, bucket)
            return self.noise(self.step, w, i, n).to(self.device)
        return self.noise(self.step, w, i, n, self.rnd).to(self.device)

    def _stack(self, i: int, n: int, dtype) -> torch.Tensor:
        if self._stacks[i] is None:
            self._stacks[i] = _wire_stack(self.n_workers, n, self.device, dtype)
        return self._stacks[i]

    def _set_scalars(self, i: int, w: int, payload: dict[str, torch.Tensor],
                     keys: tuple[str, ...]) -> None:
        for k in keys:
            if k in payload:
                if k not in self._scalars[i]:
                    self._scalars[i][k] = torch.empty(self.n_workers, dtype=f32,
                                                      device=self.device)
                self._scalars[i][k][w] = payload[k][0]

    def _gather_scalars(self, i: int, k: str) -> torch.Tensor:
        return comms.all_gather(self._scalars[i][k].reshape(self.n_workers, 1)).reshape(-1)

    def _accumulate(self, i: int, v: torch.Tensor) -> None:
        if self._sums[i] is None:
            self._sums[i] = v.clone()
        else:
            self._sums[i].add_(v)

    # ---- churn and integrity, send side ----------------------------------------

    def _gate(self, i: int, w: int) -> torch.Tensor | None:
        """Worker w's EF and momentum gate for bucket i: alive, times its
        payload's validity in the integrity program (None without churn)."""
        if self.live is None:
            return None
        if self._valid is None:
            return self.live.alive[w]
        return self.live.alive[w] * self._valid[i][w]

    def _corrupt_int8(self, i: int, w: int, code: torch.Tensor,
                      payload: dict[str, torch.Tensor], knobs: dict) -> dict[str, torch.Tensor]:
        """Worker w's int8 payload in the integrity program: its wire codes
        (``code``, its row of the stack) corrupted in place and its scalars
        corrupted where its flag is set; its validity recorded (scalars
        finite and in range, codes within the level bound).  Returns the
        corrupted scalars."""
        flag = self.live.flag[w]
        code.copy_(integrity.corrupt_codes(self.kind, code, flag))
        out = {k: integrity.corrupt_dense(self.kind, v, flag)
               for k, v in payload.items() if k != "code"}
        s = out["s"].reshape(()) if "s" in out else knobs["levels"]
        self._valid[i][w] = (integrity.scale_valid(out["norm"].reshape(()), s)
                             * integrity.code_valid(code, s))
        return out

    def _masked_dense(self, i: int, w: int, a: torch.Tensor) -> torch.Tensor:
        """Worker w's dense contribution under churn: its payload corrupted
        where flagged and validated (integrity), selected out when invalid,
        times its alive bit."""
        alive = self.live.alive[w]
        if self._valid is None:
            return a * alive
        a_w = integrity.corrupt_dense(self.kind, a, self.live.flag[w])
        valid = integrity.dense_valid(a_w)
        self._valid[i][w] = valid
        return torch.where(valid > 0, a_w, 0.0) * alive

    def add(self, w: int, bufs: Iterable[torch.Tensor]) -> None:
        """Send side of worker ``w``: ``bufs`` yields its flat f32 bucket
        vectors in plan order (a generator keeps one bucket alive at once)."""
        comm, W, live = self.comm, self.n_workers, self.live
        alive = live.alive[w] if live is not None else None
        for i, (b, comp, route, g) in enumerate(zip(self.plan.buckets, self.comps,
                                                    self.routes, bufs)):
            knobs = self.knobs[i]
            u = (self._noise(w, i, noise_len(comp, b.size)) if needs_noise(comp) else None)
            if route == "fused_ef":
                # one kernel pass yields the int8 wire codes and worker w's
                # new residual, written in place (under churn beside it, then
                # kept where the worker sent a valid payload)
                e = self.state["ef"][i][w]
                code = self._stack(i, b.size, torch.int8)[w]
                e_new = e if live is None else torch.empty_like(e)
                c, _ = comp.compress_ef_p(u, g, e, knobs, comm.ef_decay,
                                          out={"code": code, "e": e_new})
                payload = c.payload
                if self._valid is not None:
                    payload = self._corrupt_int8(i, w, code, payload, knobs)
                if live is not None:
                    torch.where(self._gate(i, w) > 0, e_new, e, out=e)
                self._set_scalars(i, w, payload, ("norm",))
                continue
            u_prev = (self.state["u"][i][w].clone()
                      if self._valid is not None and comm.momentum_correction else None)
            a = feedback.pre_compress(comm, g, self.state, i, w, W, alive=alive)
            a_hat = None
            if route == "dense":
                a_m = a if live is None else self._masked_dense(i, w, a)
                if comm.collective == "xla":  # a bf16 sum rounds after every addition
                    self._accumulate(i, a_m.to(self.dense_dtype))
                else:
                    if self._stacks[i] is None:
                        self._stacks[i] = torch.zeros(
                            (W, collectives.padded_len(b.size, W)), dtype=self.dense_dtype,
                            device=self.device)
                    self._stacks[i][w, :b.size].copy_(a_m)
            elif route == "widen":
                a_m = a if live is None else self._masked_dense(i, w, a)
                self._stack(i, b.size, torch.bfloat16)[w].copy_(a_m)
            elif route == "powersgd":
                # a_w waits for finish (the second factor needs P): in worker
                # w's EF row when EF is on and no worker can be masked (finish
                # turns it into a_w - agg), else in a stack of its own
                keep = (self.state["ef"][i] if comm.error_feedback and live is None
                        else self._stack(i, b.size, f32))
                keep[w].copy_(a)
                bb = shape2d(b.size)[1]
                q = self.state["psgd_q"][i].reshape(bb, comp.rank)
                self._accumulate(i, matmul_rows(a if live is None else a * alive, q, bb))
            elif route == "sign":
                # packed straight from a: the int8 sign payload is never formed
                row = self._stack(i, ops.sign_packed_bytes(b.size), torch.uint8)[w]
                ops.sign_pack(a, out=row)
                if self._valid is not None:  # undetectable: every bit pattern is a vote
                    row.copy_(integrity.corrupt_codes(self.kind, row, live.flag[w]))
                if comm.error_feedback:
                    a_hat = torch.where(a >= 0, 1.0, -1.0)
            elif route == "int8_acc":
                code = self._stack(i, b.size, torch.int8)[w]
                c = compress_p(comp, u, a, knobs, out={"code": code})
                if comm.error_feedback:
                    a_hat = decompress_p(comp, c, knobs)
                payload = c.payload
                if self._valid is not None:
                    payload = self._corrupt_int8(i, w, code, payload, knobs)
                self._set_scalars(i, w, payload, ("norm", "s"))
            elif route == "tern":
                c = compress_p(comp, u, a, knobs)
                row = self._stack(i, ops.tern_packed_bytes(b.size), torch.uint8)[w]
                ops.tern_pack(c.payload["tern"], out=row)
                scale = c.payload["scale"]
                if self._valid is not None:
                    flag = live.flag[w]
                    row.copy_(integrity.corrupt_codes(self.kind, row, flag))
                    scale = integrity.corrupt_dense(self.kind, scale, flag)
                    self._valid[i][w] = (integrity.packed2_valid(row)
                                         * integrity.scale_valid(scale.reshape(())))
                self._set_scalars(i, w, {"scale": scale}, ("scale",))
                if comm.error_feedback:
                    a_hat = decompress_p(comp, c, knobs)
            else:  # majority, sum, gather
                c = compress_p(comp, u, a, knobs)
                if route == "majority":
                    sign = c.payload["sign"]
                    if live is not None:
                        if self._valid is not None:
                            sign = integrity.corrupt_codes(self.kind, sign, live.flag[w])
                            self._valid[i][w] = integrity.code_valid(sign, 1.0)
                        sign = sign * self._gate(i, w).to(sign.dtype)
                    self._accumulate(i, sign)
                elif route == "sum":
                    dense = c.payload["dense"]
                    self._accumulate(i, dense if live is None else self._masked_dense(i, w, dense))
                    if "nnz" in c.payload:
                        nnz = c.payload["nnz"][0]
                        self.nnz = nnz.clone() if self.nnz is None else self.nnz + nnz
                        self.nnz_of += b.size
                else:
                    payload = c.payload
                    if self._valid is not None:
                        payload = integrity.corrupt_payload(self.kind, payload, live.flag[w])
                        self._valid[i][w] = self._payload_valid(comp, payload, knobs)
                    self._payloads[i].append(payload)
                if comm.error_feedback:
                    a_hat = decompress_p(comp, c, knobs)
            if a_hat is not None:
                feedback.post_compress(comm, a, a_hat, self.state, i, w,
                                       alive=self._gate(i, w))
            if u_prev is not None:  # a quarantined round's momentum is undone
                u_row = self.state["u"][i][w]
                torch.where(self._valid[i][w] > 0, u_row, u_prev, out=u_row)

    @staticmethod
    def _payload_valid(comp, payload: dict[str, torch.Tensor], knobs: dict) -> torch.Tensor:
        """A gathered payload's validity: its float leaves finite and in
        range, its ``code`` leaf within the level bound (when the compressor
        has levels)."""
        bound = knobs.get("levels", getattr(comp, "levels", None))
        v = torch.ones((), dtype=f32, device=next(iter(payload.values())).device)
        for k, x in payload.items():
            if x.is_floating_point():
                v = v * integrity.dense_valid(x)
            elif k == "code" and bound is not None:
                v = v * integrity.code_valid(x, bound)
        return v

    # ---- receive side ------------------------------------------------------------

    def _weights(self, i: int, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-worker decode weights ``w`` (W,) with the churn bits folded in
        (alive, and validity selected, in the integrity program), and the
        denominator of the mean; the alive bits' all-gather is booked."""
        comms.book_all_gather(self.live.alive[0], self.n_workers)
        if self._valid is None:
            return w * self.live.alive, self.n_eff
        valid = self._valid[i]
        return (torch.where(valid > 0, w * self.live.alive, 0.0),
                torch.clamp_min(torch.sum(self.live.alive * valid), 1.0))

    def _psum_denom(self, i: int) -> torch.Tensor:
        """The live-and-valid count of a psum route in the integrity program
        (a booked scalar psum), else n_eff."""
        if self._valid is None:
            return self.n_eff
        return torch.clamp_min(comms.psum((self.live.alive * self._valid[i])[:, None])[0], 1.0)

    def _powersgd(self, i: int, b: Bucket, comp, denom: torch.Tensor) -> torch.Tensor:
        """PowerSGD's receive side (the reference's ``_powersgd_aggregate``):
        P = orthonormalize(psum(M_w @ Q) / W), Q' = psum(M_w^T @ P) / W,
        agg = P @ Q'^T; Q' is the next round's Q, and with EF each worker's
        residual becomes a_w - agg.  Under churn M_w is masked by the alive
        bit, W is n_eff and a masked worker's residual freezes."""
        W, bb = self.n_workers, shape2d(b.size)[1]
        live = self.live
        comms.book_psum(self._sums[i], W)
        P = orthonormalize(self._sums[i] / denom)
        rows = (self.state["ef"][i] if self.comm.error_feedback and live is None
                else self._stacks[i])
        qsum = None
        for w in range(W):  # worker order
            t = matmul_rows_t(rows[w] if live is None else rows[w] * live.alive[w], P, bb)
            qsum = t if qsum is None else qsum.add_(t)
        comms.book_psum(qsum, W)
        qn = qsum / denom
        agg = (P @ qn.T).reshape(-1)[:b.size]
        self.state["psgd_q"][i].copy_(qn.reshape(-1))
        if self.comm.error_feedback:  # against the global approximation
            if live is None:
                rows.sub_(agg)
            else:
                ef = self.state["ef"][i]
                torch.where(live.alive[:, None] > 0, rows - agg, ef, out=ef)
        return agg

    def finish(self) -> tuple[list[torch.Tensor], dict[str, Any]]:
        """Receive side: reduce every bucket to its worker mean (or vote)."""
        W, live = self.n_workers, self.live
        # scalars filled on the device: a host-to-card copy would wait for it
        denom = torch.full((), float(W), dtype=f32, device=self.device)
        if live is not None:  # the live count: one scalar psum, untagged as there
            self.n_eff = torch.clamp_min(comms.psum(live.alive[:, None])[0], 1.0)
            denom = self.n_eff
        out = []
        with comms.tag("grad_agg"):
            for i, (b, comp, route) in enumerate(zip(self.plan.buckets, self.comps,
                                                     self.routes)):
                den = denom
                if live is not None and route in ("dense", "widen", "sum"):
                    den = self._psum_denom(i)
                if route == "dense" and self.comm.collective != "xla":
                    agg = collectives.allreduce(self._stacks[i], b.size,
                                                self.comm.collective).to(f32) / den
                elif route in ("dense", "sum"):  # sum: the dense leaf alone
                    comms.book_psum(self._sums[i], W)
                    agg = self._sums[i].to(f32) / den
                elif route == "widen":
                    agg = comms.widening_psum(self._stacks[i]) / den
                elif route == "powersgd":
                    agg = self._powersgd(i, b, comp, den)
                elif route in ("fused_ef", "int8_acc"):
                    # _int8_code_reduce: codes at wire width, then the norms
                    # and (when the payload carries it) s, each row weighing
                    # norm_w / s_w in one decode-and-accumulate pass
                    cg = comms.all_gather_compressed({"code": self._stacks[i]})["code"]
                    ng = self._gather_scalars(i, "norm")
                    sg = (self._gather_scalars(i, "s") if "s" in self._scalars[i] else
                          torch.full((), self.knobs[i]["levels"], dtype=f32, device=self.device))
                    wt = ng / sg
                    if live is not None:
                        wt, den = self._weights(i, wt)
                    agg = ops.int8_weighted_sum(cg, wt) / den
                elif route == "sign":
                    with comms.wire_format("packed1"):
                        pg = comms.all_gather(self._stacks[i])
                    if live is None:
                        wt = torch.ones(W, dtype=f32, device=self.device)
                    else:  # masked workers cast zero votes; no validation
                        comms.book_all_gather(live.alive[0], W)
                        wt = live.alive
                    votes = ops.sign_vote(pg, wt, b.size)
                    if comp.wire_reduce == "sign_vote":  # majority, ties to +1
                        agg = torch.where(votes >= 0, 1.0, -1.0)
                    else:  # mean of +-1 votes
                        agg = votes / den
                elif route == "tern":
                    # the packed 2-bit rows, then the f32 scales, each worker's
                    # scale its weight in one decode-and-accumulate pass
                    with comms.wire_format("packed2"):
                        pg = comms.all_gather(self._stacks[i])
                    wt = self._gather_scalars(i, "scale")
                    if live is not None:
                        wt, den = self._weights(i, wt)
                    agg = ops.tern_acc(pg, wt, b.size) / den
                elif route == "majority":
                    # int8 vote sum: exact for W <= 127, as the reference's psum
                    comms.book_psum(self._sums[i], W)
                    agg = torch.where(self._sums[i] >= 0, 1.0, -1.0)
                else:  # gather: every leaf booked in payload order, then decoded
                    agg = self._gather_reduce(i, b, comp, den)
                if getattr(comp, "re_sparsify", False):  # gTop-k: the k largest of the mean
                    idx = top_k(torch.abs(agg), k_of(b.size, comp.ratio, comp.k))
                    agg = torch.zeros_like(agg).index_put_((idx,), agg[idx])
                out.append(agg)
        if self._valid is not None:
            valid = self._valid[0]
            for v in self._valid[1:]:
                valid = valid * v
            quarantine_update(self.comm, self.state, live.alive, valid)
        self.state["step"] += 1
        return out, self.state

    def _gather_reduce(self, i: int, b: Bucket, comp, denom: torch.Tensor) -> torch.Tensor:
        """The ``gather`` route: each payload decoded (or scatter-added) in
        worker order; under churn a row weighs its alive bit (selected out
        when invalid, in the integrity program)."""
        W, live = self.n_workers, self.live
        payloads = self._payloads[i]
        for v in payloads[0].values():
            comms.book_all_gather(v, W)
        wrow = None
        if live is not None:
            comms.book_all_gather(live.alive[0], W)
            wrow = live.alive
            if self._valid is not None:
                wrow = live.alive * self._valid[i]
                denom = torch.clamp_min(torch.sum(wrow), 1.0)
        acc = torch.zeros(b.size, dtype=f32, device=self.device)
        for w, pw in enumerate(payloads):  # worker order
            if "indices" in pw:  # distinct within a row: no colliding adds
                vals = pw["values"]
                if wrow is not None:
                    vals = (torch.where(wrow[w] > 0, vals, 0.0) if self._valid is not None
                            else vals * wrow[w])
                acc.index_add_(0, pw["indices"], vals)
            else:
                dec = decompress_p(comp, Compressed(pw, b.size), self.knobs[i])
                if wrow is not None:
                    dec = (torch.where(wrow[w] > 0, dec, 0.0) if self._valid is not None
                           else wrow[w] * dec)
                acc = acc + dec
        return acc / denom


def _rows_view(comm_state: dict[str, Any], lo: int, hi: int, group: int) -> dict[str, Any]:
    """``comm_state`` with every per-worker stack and vector cut to rows
    lo:hi, and PowerSGD's Q to the pod's row ``group`` (views: in-place
    updates reach the whole)."""
    view = dict(comm_state)
    for k in ("ef", "u"):
        if k in view:
            view[k] = [None if e is None else e[lo:hi] for e in view[k]]
    for k in ("alive_prev", "qcount", "quarantine_total", "escalation_total"):
        if k in view:
            view[k] = view[k][lo:hi]
    if "psgd_q" in view:
        view["psgd_q"] = [q[group] if q.dim() == 2 else q for q in view["psgd_q"]]
    return view


class GroupedRound:
    """One aggregation round over W workers in ``groups`` groups of D =
    W / groups consecutive workers: pod-local SGD's in-pod aggregation,
    where each pod reduces over its own D workers (the reference's psum over
    ``data`` alone) and gets its own aggregate.  Worker w is member w % D of
    group w // D, and its member index keys its noise: the reference folds
    the index over the aggregation axes only into the key, so worker d of
    every pod draws the same dither.  Every pod books the same collectives
    over ``("data",)``; pod 0's are booked, once, as each worker's view
    sees them.  Each pod carries its own PowerSGD Q (``psgd_q[i]`` (P, ...)).
    With one group this is an :class:`AggregationRound` over the comm state
    itself.

    Churn: ``live`` is the round's draws over all W workers; without it a
    churn cell draws them here (:func:`draw_liveness`, each worker keyed by
    its index over every data axis, as the reference's ``mask_axes``) from
    ``churn_draws``, and the rejoiners' EF and momentum rows reset.

    :meth:`finish` returns the per-group lists of per-bucket aggregates and
    the comm state (``step`` advanced once)."""

    def __init__(self, comm: CommConfig, plan: BucketPlan, comm_state: dict[str, Any],
                 n_workers: int, noise: Noise, device: str | torch.device,
                 step: int | None = None, rnd: int | None = None, groups: int = 1,
                 live: Liveness | None = None, churn_draws: ChurnDraws | None = None):
        if n_workers % groups:
            raise ValueError(f"{n_workers} workers do not split into {groups} pods")
        self.state, self.D = comm_state, n_workers // groups
        if live is None and churn_enabled(comm):
            live = draw_liveness(comm, comm_state, churn_draws or seeded_churn_draws(0, device),
                                 comm_state["step"] if step is None else step, n_workers,
                                 device, rnd)
        if live is not None and live.rejoined is not None:
            reset_rows(comm_state, live.rejoined)
        self.live = live
        self.rounds = [AggregationRound(
            comm, plan, comm_state if groups == 1 else _rows_view(comm_state, g * self.D,
                                                                   (g + 1) * self.D, g),
            self.D, noise, device, step=step, rnd=rnd,
            live=None if live is None else live.rows(g * self.D, (g + 1) * self.D))
            for g in range(groups)]

    def add(self, w: int, bufs: Iterable[torch.Tensor]) -> None:
        self.rounds[w // self.D].add(w % self.D, bufs)

    @property
    def nnz(self) -> torch.Tensor | None:
        got = [r.nnz for r in self.rounds if r.nnz is not None]
        return sum(got[1:], got[0]) if got else None

    @property
    def nnz_of(self) -> int:
        return sum(r.nnz_of for r in self.rounds)

    def finish(self) -> tuple[list[list[torch.Tensor]], dict[str, Any]]:
        if len(self.rounds) == 1:
            agg, state = self.rounds[0].finish()
            return [agg], state
        out = []
        for g, r in enumerate(self.rounds):
            with comms.muted(g > 0):
                out.append(r.finish()[0])
        self.state["step"] += 1
        return out, self.state


class ShardedRound:
    """One aggregation round per model shard, over the same W workers
    (:class:`GroupedRound` each, on its shard's rows of the comm state):
    each (worker, shard)'s shard-local buckets are compressed and reduced
    over the workers, with its own error feedback and comm state.  The
    shards of one worker share their noise draws, as the reference folds
    only the aggregation axes into the key.  Every shard books the same
    collectives; shard 0's are booked, as each device's view sees them.
    With one shard this is the :class:`GroupedRound` itself.

    :meth:`add` takes worker w's buckets of shard m from ``bufs_of(m)``;
    :meth:`finish` returns the per-shard lists of per-group aggregates and
    the comm state (``step`` advanced once)."""

    def __init__(self, comm: CommConfig, plan: BucketPlan, comm_state: dict[str, Any],
                 n_workers: int, noise: Noise, device: str | torch.device, *,
                 shards: int = 1, **kw):
        self.state, self.shards = comm_state, shards
        self.rounds = [GroupedRound(comm, plan, shard_view(comm_state, m, shards), n_workers,
                                    noise, device, **kw) for m in range(shards)]

    def add(self, w: int, bufs_of: Callable[[int], Iterable[torch.Tensor]]) -> None:
        for m, r in enumerate(self.rounds):
            with comms.muted(m > 0):
                r.add(w, bufs_of(m))

    @property
    def nnz(self) -> torch.Tensor | None:
        got = [r.nnz for r in self.rounds if r.nnz is not None]
        return sum(got[1:], got[0]) if got else None

    @property
    def nnz_of(self) -> int:
        return sum(r.nnz_of for r in self.rounds)

    def finish(self) -> tuple[list[list[list[torch.Tensor]]], dict[str, Any]]:
        out = []
        for m, r in enumerate(self.rounds):
            with comms.muted(m > 0):
                out.append(r.finish()[0])
        if self.shards > 1:
            self.state["step"] += 1
        return out, self.state


def aggregate_buckets(comm: CommConfig, plan: BucketPlan, bufs: list[torch.Tensor],
                      comm_state: dict[str, Any], noise: Noise,
                      churn_draws: ChurnDraws | None = None
                      ) -> tuple[list[torch.Tensor], dict[str, Any]]:
    """One round over already-stacked gradients: ``bufs[i]`` is bucket i's
    (W, size) f32 stack.  Returns the per-bucket means and the state (a
    churn cell draws its round from ``churn_draws``)."""
    W = bufs[0].shape[0]
    rnd = GroupedRound(comm, plan, comm_state, W, noise, bufs[0].device,
                       churn_draws=churn_draws)
    for w in range(W):
        rnd.add(w, [b[w] for b in bufs])
    agg, state = rnd.finish()
    return agg[0], state
