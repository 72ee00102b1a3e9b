"""Step builder: model, gradient exchange or parameter mixing, and optimizer
for W data-parallel workers stacked on one device (counterpart of
``repro.train.steps``: ``build_bundle`` with its ``train_step``,
``inner_step``, ``sync_step``, ``gossip_step`` and ``eval_step``,
sequential or microbatch-pipelined overlap).

A step splits the global batch into W contiguous row blocks (the
reference's batch sharding over ``data``, or over ``(pod, data)``: with
``pods=P`` the W = P * D workers are the reference's mesh order, worker
w = p * D + d) and runs the workers in turn.

* **Parameters.**  Under BSP every worker applies the same aggregate, so
  the W workers share one parameter tree.  Under local SGD, post-local SGD
  and gossip their parameters diverge: each leaf, and each optimizer-state
  leaf, carries a leading worker axis (W, *shape), as each shard of the
  reference holds its own copy.  Under pod-local SGD they stay equal inside
  a pod and diverge across pods: one row per pod, (P, *shape).  Worker w
  runs forward and backward on a detached view of its row that requires
  grad (no (W, ...) gradient is ever formed), and the optimizer updates
  each row in place (``zero1``: each worker its slice of its own row, then
  every row the regathered slices).
* **Microbatching** (``microbatch`` M > 1, the reference's
  ``_sequential_grads``): each worker's rows are split into M chunks whose
  raw gradients are accumulated in f32, then (acc / M) is cast back to the
  parameter dtype; loss and metrics are the chunks' means.  The gossip step
  takes the gradient of the worker's whole rows, as the reference's does.
* **train_step** (BSP, pod-local SGD, and post-local SGD's aggregating
  steps): each worker's gradient goes, bucket by bucket, to the send side
  of an aggregation round (momentum, clipping and error feedback, then
  compression into that worker's row of the wire stack; one round per pod
  under pod-local SGD, over its D workers); the receive side reduces every
  bucket, ``clip_norm`` (if set) clips the aggregate to that global norm,
  and the optimizer applies it (to every worker's row when the parameters
  are stacked, to each pod's row its pod's aggregate).  ``kept`` is the
  share of elements that the masked sparsifiers kept this step, over all
  workers and their buckets.
* **Pipelined overlap** (``overlap="pipelined"``, the reference's
  ``_pipelined_grads``): each worker's rows split into M microbatches, and
  round k aggregates the f32 bucket gradients of the previous microbatch
  while microbatch k's forward and backward run; on the card the round runs
  on a second CUDA stream, ordered by events.  Staleness 0 primes with
  microbatch 0, runs M - 1 rounds and flushes the last; staleness 1 carries
  each worker's last microbatch in ``comm["overlap_pending"]`` to the next
  step, whose first round aggregates it scaled by ``stale_scale``.  The
  step applies sum_k agg_k / M.
* **inner_step** (local SGD): each worker's gradient, clipped to
  ``clip_norm`` on its own, goes to its own optimizer; nothing is sent.
* **sync_step**: ``sync.average_params`` over the stack.
* **gossip_step**: forward and backward, each worker's optimizer, then per
  bucket the new parameters gathered into a (W, n) f32 stack, mixed by
  ``choco_mix`` (``gossip_compress="choco"`` with a compressor) or
  ``dpsgd_mix`` (otherwise: ``"dcd"`` and a compressor-less ``"choco"``
  run plain D-PSGD, as in the reference), and scattered back; no
  ``clip_norm``, no gradient aggregation.
* **eval_step**: the forward loss of each worker's parameters on its rows,
  then the worker mean.

Churn and integrity (the reference's masked programs; ``churn_draws`` gives
each worker's two uniforms per round, beside ``noise``): a train step's
round draws each worker's participation bit and corruption flag and
reduces over the live, valid payloads (:mod:`repro_torch.core.aggregate`);
the staleness-1 pipelined step holds one mask over its M rounds, and a
rejoiner's carried-over stale bucket is gated off in round 0.  A sync step
averages over the live rows (``pull_avg``: a rejoiner adopts but does not
donate); under local and post-local SGD the parameters' wire copy is
corrupted where flagged, validated and quarantined, with the bounded
escalation into the reset; under pod-local SGD the unit is the pod, alive
when any of its workers was alive in the last in-pod round.  A gossip step
masks the ring (D-PSGD, CHOCO-SGD's mirror freeze and resync).

The model axis (``model`` M > 1, the reference's ``model`` mesh axis) is
a stacked axis of M shards too.  The parameters are the global,
padded-for-M tree, each replicated leaf held once; the forward runs the M
shards' local computations at once and books its tensor-parallel
collectives over ``("model",)``; autograd gives the true gradient, and the
reference's fix-up psum of the replicated leaves' gradients is booked
(``tp_grad_fixup``).  The bucket plan is built from the shard-local leaves
(:func:`repro_torch.models.sharding.local_defs`), and each (worker, shard)
compresses and reduces its own buckets with its own EF and comm state
(:class:`aggregate.ShardedRound`, the comm stacks W * M rows); a
replicated leaf's aggregate is shard 0's (the reference's shards may
disagree there: their buckets' scales differ).  ``clip_norm`` clips each
shard by its own local norm, as the reference's ``global_clip`` runs on
each shard's local leaves: shard m's norm is over its block of every
sharded leaf and over every replicated leaf, its block is scaled by its
factor, and a replicated leaf takes shard 0's.  ZeRO-1 slices each
shard-local leaf over the
data workers (over diverging rows too: each row's slice of each shard).
The sync and gossip steps average or mix each shard's local leaves over
the data axes, shard by shard.  Churn and integrity draw one bit and one
corruption flag per worker, which its M shards share, and keep their
counters per (worker, shard); a sync round's validity is voted over the
shards.  PowerSGD keeps a Q per (worker, shard); the pipelined step keeps
``overlap_pending`` per (worker, shard).

Ranks on the data axis (``ranks``, a
:class:`repro_torch.core.ranks.RankGroup`; BSP, local, post-local and
pod-local SGD at one pod, D-PSGD and CHOCO-SGD, under the sequential and
the pipelined step, with churn and integrity):
the W workers are spread over R processes, and each runs the programs for
its own W/R workers (:meth:`StepBundle._split`; the rounds and ZeRO-1
take them as :attr:`StepBundle.workers` and :attr:`StepBundle.rank_opt`),
and its steps run under ``comms.ranks``, so the data-axis collectives move
the other ranks' rows for real: the gathers and all-gathers, and the ring
and rhd hops and gossip neighbour exchanges as point-to-point messages.
Every rank draws the same global batch.  Per-worker state (``ef``, ``u``,
the CHOCO mirrors, ``overlap_pending``, the churn and integrity vectors,
ZeRO-1's slices) is the rank's rows only, and each rank draws only its own
workers' churn bits and corruption flags; the other workers' bits and
validity arrive through the round's collectives
(:mod:`repro_torch.core.aggregate`).  The pipelined step's rounds run on a
communication thread, so that a round's exchange, which blocks the
thread that makes it, overlaps the next microbatch
(:meth:`StepBundle._pipelined_grads`).  So are
diverging parameters and their optimizer state (:attr:`StepBundle.
held_rows` of each (rows, ...) leaf, from :attr:`StepBundle.row_start`;
pod-local SGD's one row at one pod is held by every rank); the checkpoint
layout gathers them.  Every rank books what the stacked program books (n =
W).  :func:`check_ranks` refuses the options a later slice brings.

Loss, ``ce`` and ``aux`` are worker means.  The wire bytes of each program
are booked at build time by running it once on the ``meta`` device, which
computes shapes only.  The cells of one shape class share that booking
through the bundle registry (``build_bundle(..., cache=True)``,
``bundle_cache_stats``, ``bundle_cache_clear``); each binds its own value
knobs.  With a persistent cache configured
(:mod:`repro_torch.core.compilecache`) the booking of each class is kept
on disk too, so a later process loads it instead of tracing.

``build_serve`` is the serving counterpart (``ServeBundle``: prefill a batch
of prompts, then one greedy token per call), for every ported family; one
card is one device, so there is no mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import aggregate, comms, gossip, integrity, sync
from repro_torch.core.compression.base import get_compressor
from repro_torch.core.ranks import RankGroup
from repro_torch.core.types import (
    BundleSpec,
    CommConfig,
    bundle_spec,
    churn_enabled,
    effective_corruption_kind,
)
from repro_torch.data.pipeline import input_specs
from repro_torch.models import transformer as T
from repro_torch.models.sharding import local_defs, shard_dims, shard_local
from repro_torch.optim.optimizers import Optimizer, clip_scale, global_clip
from repro_torch.utils.tree import leaves, tree_map, unflatten_like

f32 = torch.float32


def param_rows(comm: CommConfig, n_workers: int, pods: int) -> int:
    """Rows of diverging parameters: one per pod under pod-local SGD, one
    per worker under local and post-local SGD and gossip; 0 for the one
    tree every worker shares (BSP)."""
    if comm.pod_local:
        return pods
    if comm.sync in ("local", "post_local") or comm.aggregator == "gossip":
        return n_workers
    return 0


class _RoundProgress:
    """What the step's main thread waits on of one pipelined round: per
    worker it runs, a host flag set once the round's send side has read the
    worker's rows of ``pending`` (and on the card the side stream's event
    recorded then), the event that ends the round, and over ranks the
    round's future on the communication thread (``failed`` once it
    raised: every flag is set so that no wait hangs)."""

    def __init__(self, n: int):
        self.flags = [threading.Event() for _ in range(n)]
        self.freed: list = [None] * n
        self.done = None
        self.failed = False
        self.future = None

    def wait_freed(self, r: int, dev: torch.device, group: RankGroup | None) -> None:
        """Before worker r's rows are refilled: its host flag (the seconds
        waited are ``exposed_s``), the round's error if it failed, and the
        side stream's event on the main stream."""
        if not self.flags[r].is_set():
            t0 = time.perf_counter()
            self.flags[r].wait()
            group.stats.exposed_s += time.perf_counter() - t0
        if self.failed:
            self.future.result()  # raises the round's error, once the round has ended
        if self.freed[r] is not None:
            torch.cuda.current_stream(dev).wait_event(self.freed[r])

    def join(self, dev: torch.device, group: RankGroup | None) -> None:
        """The round's end, before the sums are read."""
        if self.future is not None:
            t0 = time.perf_counter()
            try:
                self.future.result()
            finally:
                group.stats.exposed_s += time.perf_counter() - t0
        if self.done is not None:
            torch.cuda.current_stream(dev).wait_event(self.done)


def _settle(futures: list, err: BaseException) -> None:
    """After the main thread's error ``err``: wait until every round in
    flight has ended or failed (the transport is then free), and note a
    round's own error on ``err``."""
    from concurrent.futures import wait

    wait(futures)
    for f in futures:
        if f.exception() is not None and f.exception() is not err:
            err.add_note(f"a pipelined round failed too: {f.exception()!r}")


@dataclass
class StepBundle:
    cfg: ModelConfig
    comm: CommConfig
    shape: InputShape
    n_workers: int
    device: torch.device
    bucket_plan: aggregate.BucketPlan
    opt: Optimizer
    noise: aggregate.Noise
    #: global-norm clip of the aggregated gradient, and of each worker's own
    #: gradient on an inner step (0: off)
    clip_norm: float = 0.0
    #: gradient-accumulation chunks per worker and step (the pipelined
    #: step's microbatches)
    microbatch: int = 1
    #: pods P of the two-level (pod, data) layout (1: no pod axis)
    pods: int = 1
    #: shards M of the model axis (1: no model axis)
    model: int = 1
    #: each parameter leaf's sharded dimension (None: replicated), leaf order
    shard_dims: tuple = ()
    #: per-call wire bytes of each program, booked from one shape-only run:
    #: {name: {tag: bytes}, name + "_formats": {format: bytes}} for the
    #: programs of the scheme ("train", "inner", "sync", "gossip"); a
    #: pipelined train call books its M rounds
    wire: dict[str, dict[str, float]] = field(default_factory=dict)
    #: the booked records of each program's shape-only run (axes included)
    logs: dict[str, comms.CommLog] = field(default_factory=dict)
    #: churn_draws(step, worker[, round]) -> (u_mask, u_corrupt): each
    #: worker's participation and corruption uniforms of a churn round
    churn_draws: aggregate.ChurnDraws | None = None
    #: this process's rank of the data axis (None: every worker stacked here)
    ranks: RankGroup | None = None
    #: the pipelined step's side stream on the card (made at first use)
    _side: Any = field(default=None, repr=False, compare=False)
    #: over ranks, the pipelined step's communication thread: a
    #: single-worker executor and its thread's id (made at first use)
    _comm: Any = field(default=None, init=False, repr=False, compare=False)
    #: the meta-device wire trace's one traced gradient per (rows, microbatch)
    _meta_grads: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def rows(self) -> int:
        return param_rows(self.comm, self.n_workers, self.pods)

    @property
    def stacked(self) -> bool:
        return self.rows > 0

    def row_of(self, w: int) -> int:
        """The parameter row worker w differentiates and updates."""
        return w // (self.n_workers // self.rows)

    @property
    def row_start(self) -> int:
        """The first parameter row this process holds (its first worker's)."""
        return 0 if self.ranks is None or not self.stacked else self.row_of(self.ranks.lo)

    @property
    def held_rows(self) -> int:
        """The parameter rows this process holds: all, or over ranks its
        workers' rows (W/R of them, or pod-local SGD's one row at one pod)."""
        if self.ranks is None or not self.stacked:
            return self.rows
        return self.row_of(self.ranks.hi - 1) + 1 - self.row_start

    def local_row(self, w: int) -> int:
        """Worker w's parameter row among the rows this process holds."""
        return self.row_of(w) - self.row_start

    @property
    def workers(self) -> range:
        """The workers this process runs: all W, or its rank's W/R."""
        return range(self.n_workers) if self.ranks is None else self.ranks.workers

    def _own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (W, ...) per-worker tensor (all when stacked)."""
        return x if self.ranks is None else x[self.ranks.lo:self.ranks.hi]

    def _all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's rows of a per-worker tensor this rank holds its rows
        of: the ranks' rows gathered in worker order, in host memory (only a
        checkpoint reads them; stacked, ``x``)."""
        if self.ranks is None:
            return x
        return self.ranks.gather(x, host=True).reshape((-1,) + tuple(x.shape[1:]))

    def _all_param_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every parameter row of a diverging (held rows, ...) leaf: the
        ranks' rows gathered when each holds only its own."""
        return x if self.held_rows == self.rows else self._all_rows(x)

    def _own_param_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a diverging (rows, ...) leaf."""
        if self.held_rows == self.rows:
            return x
        return x[self.row_start:self.row_start + self.held_rows].clone()

    def _worker_stack(self, vals: list[torch.Tensor]) -> torch.Tensor:
        """A (W, ...) stack of one value per worker from this process's own
        workers' ``vals`` (the other ranks' rows left for the collective
        that gathers them)."""
        return comms.worker_stack(torch.stack(vals))

    def _own_worker_bits(self, row_bits: torch.Tensor) -> torch.Tensor:
        """One entry per worker this process runs from ``row_bits``, one per
        parameter row it holds (each row stands for W / rows workers)."""
        per = self.n_workers // self.rows
        start = self.workers.start - self.row_start * per
        return row_bits.repeat_interleave(per)[start:start + len(self.workers)]

    @property
    def groups(self) -> int:
        """Aggregation groups: the pods under pod-local SGD, else one."""
        return self.pods if self.comm.pod_local else 1

    @property
    def data_axes(self) -> tuple[str, ...]:
        return ("pod", "data") if self.pods > 1 else ("data",)

    @property
    def agg_axes(self) -> tuple[str, ...]:
        """The axes a gradient aggregation reduces over (the pod's own
        ``data`` axis under pod-local SGD)."""
        return ("data",) if self.comm.pod_local else self.data_axes

    # ---- the model axis -----------------------------------------------------------

    def local_leaves(self, ts: list[torch.Tensor], m: int, lead: int = 0,
                     replicated: bool = True) -> list[torch.Tensor]:
        """Shard m's local leaves of the global leaves ``ts`` (views), each
        with ``lead`` leading row dimensions; ``replicated`` False leaves
        the replicated leaves out of every shard but shard 0."""
        return [shard_local(t, None if d is None else d + lead, self.model, m)
                for t, d in zip(ts, self.shard_dims) if d is not None or replicated or m == 0]

    def _bufs_of(self, grads: list[torch.Tensor]) -> Callable[[int], Any]:
        """Shard m's flat f32 buckets of the global gradient (a generator)."""
        def bufs(m: int):
            loc = self.local_leaves(grads, m)
            return (aggregate.gather_bucket(b, loc) for b in self.bucket_plan.buckets)
        return bufs

    def _scatter(self, per_shard: list[list[torch.Tensor]], like: list[torch.Tensor]
                 ) -> list[torch.Tensor]:
        """The global gradient leaves from each shard's bucket aggregates
        (``per_shard[m][i]``): a sharded leaf's blocks from their shards, a
        replicated leaf from shard 0."""
        plan, M = self.bucket_plan, self.model
        if M == 1:
            return aggregate._scatter_buckets(plan, per_shard[0], like)
        out: list[torch.Tensor | None] = [None] * len(like)
        for m, vals in enumerate(per_shard):
            for b, v in zip(plan.buckets, vals):
                off = 0
                for i, n in b.segments:
                    seg, off, dim = v[off:off + n], off + n, self.shard_dims[i]
                    if dim is None:
                        if m == 0:
                            out[i] = seg.reshape(like[i].shape).to(like[i].dtype)
                        continue
                    if out[i] is None:
                        out[i] = torch.empty(like[i].shape, dtype=like[i].dtype,
                                             device=like[i].device)
                    blk = shard_local(out[i], dim, M, m)
                    blk.copy_(seg.reshape(blk.shape))
        return out

    def _clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """``clip_norm`` as the reference applies it inside ``shard_map``:
        the global norm at model-axis size 1; under the model axis each
        shard by its own local norm (:meth:`local_leaves`, the replicated
        leaves included), its block of a sharded leaf scaled by its factor
        and a replicated leaf by shard 0's."""
        if not self.clip_norm or self.model == 1:
            return global_clip(grads, self.clip_norm)
        M = self.model
        scales = [clip_scale(self.local_leaves(grads, m), self.clip_norm) for m in range(M)]
        out = []
        for g, d in zip(grads, self.shard_dims):
            if d is None:
                out.append((g.to(f32) * scales[0]).to(g.dtype))
                continue
            new = torch.empty_like(g)
            for m, sc in enumerate(scales):
                shard_local(new, d, M, m).copy_((shard_local(g, d, M, m).to(f32) * sc).to(g.dtype))
            out.append(new)
        return out

    def _book_fixup(self, grads: list[torch.Tensor]) -> None:
        """The reference's ``_fix_model_grads`` psum of each replicated
        leaf's gradient over the model axis (tag ``tp_grad_fixup``).
        Autograd already sums the shards' contributions, so only the wire is
        booked."""
        if self.model == 1:
            return
        with comms.tag("tp_grad_fixup"):
            for g, d in zip(grads, self.shard_dims):
                if d is None:
                    comms.book_model("psum", g, self.model)

    # ---- state ----------------------------------------------------------------

    def _place(self, params: Any, stack: bool) -> Any:
        """Parameters on the device: ``stack`` repeats one tree into its
        rows; a shared tree requires grad (its leaves are differentiated
        directly)."""
        def place(p):
            p = p.detach().to(self.device)
            if stack:
                return torch.stack([p] * self.held_rows)
            return p if self.stacked else p.requires_grad_(True)

        return tree_map(place, params)

    @property
    def rank_opt(self) -> Optimizer:
        """The optimizer this process runs: :attr:`opt`, or over ranks
        ZeRO-1's that holds and updates this rank's rows only."""
        if self.ranks is None or not self.opt.n_shards:
            return self.opt
        return self.opt.for_ranks(self.ranks.workers)

    def init_state(self, params: Any) -> dict[str, Any]:
        """The step state from one parameter tree (every worker starts from
        it; over ranks, this rank's rows of the per-worker state)."""
        params = self._place(params, stack=self.stacked)
        sharded = self.stacked and self.opt.n_shards  # zero1's slices of one row
        return {
            "params": params,
            "opt": self.rank_opt.init(tree_map(lambda p: p[0], params) if sharded else params),
            "comm": aggregate.init_comm_state(self.comm, self.bucket_plan, self.n_workers,
                                              self.device, self.pods, self.model,
                                              workers=self.workers),
            "step": 0,
        }

    def _meta_state(self) -> dict[str, Any]:
        """A state of the right structure, shapes and dtypes that holds no
        memory."""
        meta = dataclasses.replace(self, device=torch.device("meta"))
        return meta.init_state(tree_map(
            lambda d: torch.empty(d.shape, dtype=self.cfg.pdtype, device="meta"),
            T.param_defs(self.cfg, self.model)))

    # ---- checkpoint layout ------------------------------------------------------

    def checkpoint_tree(self, state: dict[str, Any]) -> dict[str, Any]:
        """``state`` in the reference's checkpoint layout, so that paths and
        shapes agree with the reference's for a BSP run: each optimizer-state
        list of per-leaf tensors becomes a tree shaped like the parameters
        (``opt/v/embed/embedding``); ZeRO-1's (W, k) shard rows and each
        per-worker comm stack (W, n) become the reference's global arrays,
        the W shards concatenated (a bucket without a compressor, whose EF
        row the port leaves out, is the reference's zeros); PowerSGD's Q,
        shared here, is repeated once per worker, as each reference shard
        holds it (under pod-local SGD over several pods, each pod's Q once
        per worker of the pod).  The churn and integrity entries
        (``alive_prev``, ``pod_alive_prev``, ``qcount``,
        ``quarantine_total``, ``escalation_total``) are (W,) here as there
        (over ranks gathered from each rank's own rows).
        Diverging parameters keep their rows (W, or P under pod-local SGD),
        and so does their optimizer state.  Under the model axis the
        parameters are the global tree and every per-worker entry has one
        row per (worker, shard), in the
        reference's device order: the stacks, the churn and integrity
        vectors, ZeRO-1's (W, M, k) slices and each shard's Q.  Over ranks
        every rank gathers the per-worker rows (``ef``, ``u``, the CHOCO
        mirrors, ZeRO-1's slices, diverging parameters and their optimizer
        state) into that layout, so every rank must call this.  Views where
        it can."""
        W, defs = self.n_workers * self.model, T.param_defs(self.cfg, self.model)
        n_leaves = len(leaves(defs))

        def opt_ref(x):
            if isinstance(x, dict):
                return {k: opt_ref(v) for k, v in x.items()}
            if isinstance(x, list) and len(x) == n_leaves:
                return unflatten_like(defs, [self._all_rows(t).reshape(-1) if self.opt.n_shards
                                             else self._all_param_rows(t) if self.stacked
                                             else t for t in x])
            return x

        comm = dict(state["comm"])
        for k in aggregate.COMM_STACKS:
            if k in comm:
                comm[k] = [torch.zeros(W * b.size, dtype=f32, device=self.device)
                           if e is None else self._all_rows(e).reshape(-1)
                           for e, b in zip(comm[k], self.bucket_plan.buckets)]
        for k in aggregate.WORKER_VECTORS:
            if k in comm:
                comm[k] = self._all_rows(comm[k])
        if "psgd_q" in comm:  # each group's (shard's) Q on each of its workers
            G, M = self.groups, self.model
            comm["psgd_q"] = [q.reshape(G, 1, M, -1).expand(-1, self.n_workers // G, -1, -1)
                              .reshape(-1) if q.numel() else q.reshape(-1)
                              for q in comm["psgd_q"]]
        params = state["params"]
        if self.stacked:
            params = tree_map(self._all_param_rows, params)
        return {"params": params, "opt": opt_ref(state["opt"]), "comm": comm,
                "step": state["step"]}

    def checkpoint_like(self, keys: tuple[str, ...] = ("params", "opt", "comm", "step")
                        ) -> dict[str, Any]:
        """The checkpoint layout's structure, shapes and dtypes (on the
        ``meta`` device), restricted to ``keys``: the ``like`` tree of
        ``checkpoint.restore``."""
        meta = dataclasses.replace(self, device=torch.device("meta"), ranks=None)
        tree = meta.checkpoint_tree(meta._meta_state())
        return {k: tree[k] for k in keys}

    def _opt_from_checkpoint(self, tree: Any, tmpl: Any) -> Any:
        if isinstance(tmpl, dict):
            return {k: self._opt_from_checkpoint(tree[k], v) for k, v in tmpl.items()}
        if isinstance(tmpl, list):
            if self.ranks is not None and self.opt.n_shards:  # this rank's (W, k) rows
                return [self._own_rows(a.reshape(t.shape)).clone()
                        for a, t in zip(leaves(tree), tmpl)]
            if self.stacked:  # this process's rows of each diverging leaf's state
                return [self._own_param_rows(a.reshape(t.shape))
                        for a, t in zip(leaves(tree), tmpl)]
            return [a.reshape(t.shape) for a, t in zip(leaves(tree), tmpl)]
        return tree

    def from_checkpoint(self, tree: dict[str, Any]) -> dict[str, Any]:
        """Inverse of :meth:`checkpoint_tree` on a tree restored from it;
        ``tree`` may hold only some of its keys (``restore_rejoin``: no
        ``comm``).  Over ranks each rank keeps its own rows of the
        per-worker entries."""
        tmpl = dataclasses.replace(self, ranks=None)._meta_state()  # the global layout
        out = {}
        if "params" in tree:
            out["params"] = self._place(tree["params"], stack=False)
            if self.stacked:
                out["params"] = tree_map(self._own_param_rows, out["params"])
        if "opt" in tree:
            out["opt"] = self._opt_from_checkpoint(tree["opt"], tmpl["opt"])
        if "comm" in tree:
            comm = dict(tree["comm"])
            for k in aggregate.COMM_STACKS:
                if k in comm:
                    comm[k] = [None if t is None else
                               self._own_rows(e.reshape(t.shape)).clone() if self.ranks else
                               e.reshape(t.shape) for e, t in zip(comm[k], tmpl["comm"][k])]
            for k in aggregate.WORKER_VECTORS:
                if k in comm and self.ranks is not None:
                    comm[k] = self._own_rows(comm[k]).clone()
            if "psgd_q" in comm:  # worker 0 of each group holds the group's Q
                G, M = self.groups, self.model
                comm["psgd_q"] = [q.reshape(G, self.n_workers // G, M, -1)[:, 0].reshape(t.shape)
                                  if t.numel() else q.reshape(t.shape)
                                  for q, t in zip(comm["psgd_q"], tmpl["comm"]["psgd_q"])]
            out["comm"] = comm
        if "step" in tree:
            out["step"] = tree["step"]
        return out

    # ---- per-worker pieces ------------------------------------------------------

    def _split(self, batch: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
        """Worker w's contiguous rows of the global batch, for each worker
        this process runs (:attr:`workers`: all W, or its rank's), in order."""
        B, W = batch["tokens"].shape[0], self.n_workers
        if B % W:
            raise ValueError(f"global batch {B} does not split over {W} workers")
        bl = B // W
        return [{k: v[w * bl:(w + 1) * bl] for k, v in batch.items()} for w in self.workers]

    def _worker_params(self, params: Any, w: int, grad: bool = True) -> Any:
        if not self.stacked:
            return params
        r = self.local_row(w)
        if not grad:
            return tree_map(lambda p: p[r], params)
        return tree_map(lambda p: p[r].detach().requires_grad_(True), params)

    def _grads(self, params: Any, part: dict[str, torch.Tensor], microbatch: int,
               tag: Any = None) -> tuple[list[torch.Tensor], dict[str, torch.Tensor]]:
        """One worker's gradients (leaf order) and its loss and metrics.  On
        the meta device (the wire trace, shapes only) every worker's
        gradients have the same shapes and book the same collectives, so
        the first worker's trace (for each ``tag``: the pipelined step's
        microbatch) stands for the rest."""
        if part["tokens"].is_meta:
            key = (part["tokens"].shape, microbatch, tag)
            if key not in self._meta_grads:
                self._meta_grads[key] = self._traced_grads(params, part, microbatch)
            grads, m = self._meta_grads[key]
            return [torch.empty_like(g) for g in grads], dict(m)
        return self._traced_grads(params, part, microbatch)

    def _traced_grads(self, params: Any, part: dict[str, torch.Tensor], microbatch: int
                      ) -> tuple[list[torch.Tensor], dict[str, torch.Tensor]]:
        pleaves = leaves(params)
        if microbatch == 1:
            loss, m = T.forward_loss(self.cfg, params, part, msize=self.model)
            grads = list(torch.autograd.grad(loss, pleaves))
            self._book_fixup(grads)
            return grads, {"loss": loss.detach(), **{k: v.detach() for k, v in m.items()}}
        rows = part["tokens"].shape[0]
        if rows % microbatch:
            raise ValueError(f"local batch {rows} does not split into {microbatch} microbatches")
        mb = rows // microbatch
        acc = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in pleaves]
        ms: dict[str, list[torch.Tensor]] = {"loss": [], "ce": [], "aux": []}
        for j in range(microbatch):
            loss, m = T.forward_loss(self.cfg, params, {k: v[j * mb:(j + 1) * mb]
                                                        for k, v in part.items()},
                                     msize=self.model)
            for a, g in zip(acc, torch.autograd.grad(loss, pleaves)):
                a.add_(g.to(f32))
            for k, v in (("loss", loss), *m.items()):
                ms[k].append(v.detach())
        grads = [(a / microbatch).to(p.dtype) for a, p in zip(acc, pleaves)]
        self._book_fixup(grads)
        return grads, {k: torch.mean(torch.stack(v)) for k, v in ms.items()}

    def _update(self, opt_state: Any, params: Any, grads_of: Callable[[int], list],
                lr: float) -> Any:
        """The optimizer on the shared tree (``grads_of(0)``), or on each
        row this process holds in place (``grads_of(r)`` of the global row r,
        called in row order; ``zero1`` reads each worker's slice of its own
        row); a 0-dim state leaf (adamw's ``t``) advances once, as each row's
        update returns the same value.  ``zero1``'s all-gather is booked over
        every data axis."""
        pleaves, opt, start = leaves(params), self.rank_opt, self.row_start
        if not self.stacked:
            with comms.over(self.data_axes):
                return opt.update(grads_of(0), opt_state, pleaves, lr)[1]
        if opt.update_rows is not None:
            with comms.over(self.data_axes):
                return opt.update_rows(lambda r: grads_of(r + start), opt_state, pleaves, lr,
                                       self.local_row)
        new = opt_state
        for r in range(self.held_rows):
            rows = tree_map(lambda x: x[r] if isinstance(x, torch.Tensor) and x.ndim else x,
                            opt_state)
            new = opt.update(grads_of(r + start), rows, [p[r] for p in pleaves], lr)[1]
        return unflatten_like(opt_state, [o if o.ndim else n for o, n in
                                          zip(leaves(opt_state), leaves(new))])

    def _metrics(self, ms: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
        """The worker means of this process's workers' metrics (in worker
        order)."""
        with comms.over(self.data_axes):
            return {k: comms.pmean(self._worker_stack([m[k] for m in ms]))
                    for k in ("loss", "ce", "aux")}

    def _round(self, state: dict[str, Any], rnd: int | None = None,
               live: aggregate.Liveness | None = None) -> aggregate.ShardedRound:
        return aggregate.ShardedRound(self.comm, self.bucket_plan, state["comm"],
                                      self.n_workers, self.noise, self.device,
                                      shards=self.model, step=state["step"], rnd=rnd,
                                      groups=self.groups, live=live,
                                      churn_draws=self.churn_draws,
                                      workers=None if self.ranks is None else self.workers)

    def _step_mask(self, state: dict[str, Any]) -> tuple:
        """One participation bit per worker for a whole step (the sync,
        gossip and staleness-1 pipelined steps), drawn and windowed at the
        trainer step, with no round index (:func:`aggregate.draw_mask`)."""
        return aggregate.draw_mask(self.comm, state["comm"], self.churn_draws, state["step"],
                                   state["step"], self.n_workers, self.device,
                                   workers=self.workers)

    def _sequential_grads(self, state: dict[str, Any], parts: list[dict[str, torch.Tensor]]
                          ) -> tuple[list[list[torch.Tensor]], list[dict], Any]:
        """Every worker's (microbatch-accumulated) gradient through one
        round: returns the per-shard lists of per-group bucket aggregates,
        the per-worker metrics and the round."""
        rnd, ms = self._round(state), []
        for w, part in zip(self.workers, parts):
            grads, m = self._grads(self._worker_params(state["params"], w), part,
                                   self.microbatch)
            rnd.add(w, self._bufs_of(grads))
            del grads
            ms.append(m)
        return rnd.finish()[0], ms, rnd

    def _side_stream(self):
        if self.device.type != "cuda":
            return None  # the CPU (and the meta device) run the rounds in program order
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _comm_thread(self):
        """Over ranks, the pipelined step's communication thread: (a
        single-worker executor, its thread's id), made at first use."""
        if self._comm is None:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(1, thread_name_prefix="repro-comm")
            self._comm = (pool, pool.submit(threading.get_ident).result())
        return self._comm

    def _pipelined_grads(self, state: dict[str, Any], parts: list[dict[str, torch.Tensor]]
                         ) -> tuple[list[list[torch.Tensor]], list[dict], Any]:
        """The reference's ``_pipelined_grads``: round k aggregates the f32
        bucket gradients of the microbatch before k (``pending``, one row
        per worker this process runs, per bucket) while microbatch k's
        forward and backward run; returns the per-group sum_k scale_k agg_k
        / M, the per-worker metrics (means over the microbatches) and the
        kept-element counts.

        Stacked, each round runs in program order, on the card on the side
        stream after the main stream's work so far (the microbatch that
        filled ``pending``); worker w's rows of ``pending`` are refilled only
        after the event recorded when the round's send side has read them,
        and the main stream waits for the last round before it reads the
        sums.  The buffers the side stream touches (``pending``, the sums,
        the comm state) are held until then; the round's own temporaries
        live in the side stream's pool, which every round enters after the
        main stream.  Each round keys its noise with its index; the M
        rounds are booked once under ``comms.loop``, as the reference books
        its scan.

        Over ranks a round's exchange blocks its thread (the staging of card
        tensors and every ``torch.distributed`` call wait on the host), so
        each round runs on the bundle's communication thread
        (:meth:`_comm_thread`), which owns the transport meanwhile
        (:meth:`RankGroup.owned_by`) and books into the caller's capture
        (``comms.entered``; the main thread books nothing then,
        ``comms.closed``): after the main thread has queued microbatch k, it
        records an event on the main stream and submits round k, whose
        thread makes the side stream wait on that event (not on the whole
        main stream, whose queue holds microbatch k + 1 by then).  As the
        round's send side has read worker w's rows it records w's event and
        sets w's host flag; the main thread waits for the flag (its seconds
        are ``RankStats.exposed_s``) and the event before it refills them,
        and joins the last round before it reads the sums.  On the CPU the
        same protocol runs with the host flags alone.  A round's error
        reaches the main thread once that round has ended or failed; an
        error of the main thread surfaces once the rounds in flight have.

        Under the model axis (S shards) ``pending`` holds one row per
        (worker, shard), w * S + s, each shard's local buckets; every round
        is a :class:`aggregate.ShardedRound` and the sums are per shard.
        Each microbatch's forward collectives and ``tp_grad_fixup`` are
        booked once per microbatch, as the reference's scan books its
        body."""
        comm, plan, M = self.comm, self.bucket_plan, self.microbatch
        params, dev, S, K = state["params"], self.device, self.model, len(self.workers)
        rows = parts[0]["tokens"].shape[0]
        if rows % M:
            raise ValueError(f"local batch {rows} does not split into {M} microbatches")
        mb, side = rows // M, self._side_stream()
        pool, owner = self._comm_thread() if self.ranks is not None else (None, None)
        acc = [[[torch.zeros(b.size, dtype=f32, device=dev) for b in plan.buckets]
                for _ in range(self.groups)] for _ in range(S)]
        ms: list[list[dict[str, torch.Tensor]]] = [[] for _ in range(K)]
        kept = {"nnz": None, "of": 0}

        def fill(j: int, prog: _RoundProgress | None) -> None:
            """Microbatch j of every worker this process runs into
            ``pending``, worker w's rows once round ``prog`` has read them."""
            for r, (w, part) in enumerate(zip(self.workers, parts)):
                with comms.muted(r > 0):  # every worker books the same collectives
                    grads, m = self._grads(self._worker_params(params, w),
                                           {k: v[j * mb:(j + 1) * mb] for k, v in part.items()},
                                           1, tag=j)
                if prog is not None:
                    prog.wait_freed(r, dev, self.ranks)
                with torch.no_grad():
                    for s in range(S):
                        loc = self.local_leaves(grads, s)
                        for i, b in enumerate(plan.buckets):  # f32 widening, as gather_bucket
                            off = 0
                            for li, n in b.segments:
                                pending[i][r * S + s, off:off + n].copy_(loc[li].reshape(-1))
                                off += n
                del grads
                ms[r].append(m)

        # churn under the staleness-1 double buffer: one mask for the step,
        # held over its M rounds; a rejoiner's carried-over stale bucket
        # (round 0, computed while it was out) is gated off as well
        step_mask = None
        if churn_enabled(comm) and comm.overlap_staleness == 1:
            step_mask = self._step_mask(state)
        kind = effective_corruption_kind(comm)

        def live_of(k: int) -> aggregate.Liveness | None:
            if step_mask is None:
                return None  # the round draws its own (staleness 0) or none
            alive, rejoined, window, _ = step_mask
            a_k = alive * (1.0 - rejoined) if k == 0 else alive
            flag = None
            if kind != "none":  # the corruption draw is the round's
                _, u_corr = aggregate.draw_uniforms(self.churn_draws, state["step"],
                                                    self.workers, k, dev)
                flag = aggregate.corruption_flags(comm, u_corr, a_k, window)
            return aggregate.Liveness(a_k, rejoined if k == 0 else None, flag, kind)

        def run_round(k: int, scale: float, prog: _RoundProgress, ready=None) -> None:
            """Round k over ``pending``, its aggregates (times ``scale``)
            added into ``acc``; marks ``prog`` as it reads each worker's
            rows and as it ends (on the card after event ``ready``, else
            after the main stream's work so far)."""
            if side is not None:
                if ready is None:
                    side.wait_stream(torch.cuda.current_stream(dev))
                else:
                    side.wait_event(ready)
            with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
                rnd = self._round(state, rnd=k, live=live_of(k))
                for r, w in enumerate(self.workers):
                    rnd.add(w, lambda s, r=r: [p[r * S + s] for p in pending])
                    prog.freed[r] = side.record_event() if side is not None else None
                    prog.flags[r].set()
                aggs = rnd.finish()[0]
                sc = torch.full((), scale, dtype=f32, device=dev)
                for acc_s, agg_s in zip(acc, aggs):
                    for acc_g, agg_g in zip(acc_s, agg_s):
                        for a, x in zip(acc_g, agg_g):
                            a.add_(x * sc)
                del aggs
                if rnd.nnz is not None:
                    kept["nnz"] = rnd.nnz if kept["nnz"] is None else kept["nnz"] + rnd.nnz
                    kept["of"] += rnd.nnz_of
                prog.done = side.record_event() if side is not None else None

        def on_thread(ctx: dict, k: int, scale: float, prog: _RoundProgress, ready,
                      prev: _RoundProgress | None) -> None:
            try:
                if prev is not None and prev.failed:  # queued behind a failed round
                    raise RuntimeError(f"pipelined round {k}: an earlier round failed")
                if side is not None:
                    torch.cuda.set_device(dev)
                with comms.entered(ctx):
                    run_round(k, scale, prog, ready)
            except BaseException:
                prog.failed = True  # wake the main thread, which then reads the error
                for f in prog.flags:
                    f.set()
                raise

        futures, progs = [], []

        def start(k: int, scale: float) -> _RoundProgress:
            prog = _RoundProgress(K)
            if pool is None:  # stacked: in program order (on the card, the side stream)
                run_round(k, scale, prog)
                return prog
            ready = torch.cuda.current_stream(dev).record_event() if side is not None else None
            prog.future = pool.submit(on_thread, comms.context(), k, scale, prog, ready,
                                      progs[-1] if progs else None)
            futures.append(prog.future)
            progs.append(prog)
            return prog

        if comm.overlap_staleness == 1:
            pending = state["comm"]["overlap_pending"]
        else:
            pending = [torch.empty((K * S, b.size), dtype=f32, device=dev)
                       for b in plan.buckets]
        with contextlib.ExitStack() as stack:
            if pool is not None:
                stack.enter_context(self.ranks.owned_by(owner))
                stack.enter_context(comms.closed())
            try:
                if comm.overlap_staleness == 1:
                    with comms.loop(M):
                        for k in range(M):
                            with comms.muted(k > 0):
                                prog = start(k, comm.stale_scale if k == 0 else 1.0)
                                fill(k, prog)
                else:
                    fill(0, None)
                    with comms.loop(M - 1):
                        for k in range(M - 1):
                            with comms.muted(k > 0):
                                prog = start(k, 1.0)
                                fill(k + 1, prog)
                    prog = start(M - 1, 1.0)  # the flush
                prog.join(dev, self.ranks)
                for f in futures:  # every round has ended: none failed unread
                    f.result()
            except BaseException as e:
                _settle(futures, e)
                raise
        del pending
        metrics = [{k: torch.mean(torch.stack([d[k] for d in mw])) for k in mw[0]} for mw in ms]
        return [[[a / M for a in acc_g] for acc_g in acc_s] for acc_s in acc], metrics, kept

    # ---- the programs -------------------------------------------------------------

    def train_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                   lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        with comms.ranks(self.ranks):
            return self._train_step(state, batch, lr)

    def _train_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                    lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        params, plan, parts = state["params"], self.bucket_plan, self._split(batch)
        with comms.over(self.agg_axes):
            if self.comm.overlap == "pipelined":
                aggs, ms, kept = self._pipelined_grads(state, parts)
                nnz, nnz_of = kept["nnz"], kept["of"]
            else:
                aggs, ms, rnd = self._sequential_grads(state, parts)
                nnz, nnz_of = rnd.nnz, rnd.nnz_of
        like = [p[0] for p in leaves(params)] if self.stacked else leaves(params)
        # one aggregate per pod under pod-local SGD (row r is pod r), else
        # one; aggs[m][g] is shard m's of group g
        grads = [self._clip(self._scatter([a[g] for a in aggs], like))
                 for g in range(len(aggs[0]))]
        del aggs
        own = self.comm.pod_local
        opt_state = self._update(state["opt"], params, lambda r: grads[r if own else 0], lr)
        out = self._metrics(ms)
        if nnz is not None:  # the masked sparsifiers' kept share (no collective booked)
            out["kept"] = nnz / nnz_of
        # each round advanced the comm state's step (M per pipelined step, as there)
        return ({"params": params, "opt": opt_state, "comm": state["comm"],
                 "step": state["step"] + 1}, out)

    def inner_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                   lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        """A local step: no gradient leaves its worker."""
        with comms.ranks(self.ranks):
            return self._inner_step(state, batch, lr)

    def _inner_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                    lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        params, parts, ms = state["params"], self._split(batch), []

        def grads_of(w):
            grads, m = self._grads(self._worker_params(params, w),
                                   parts[w - self.workers.start], self.microbatch)
            ms.append(m)
            return self._clip(grads)

        opt_state = self._update(state["opt"], params, grads_of, lr)
        return ({"params": params, "opt": opt_state, "comm": state["comm"],
                 "step": state["step"] + 1}, self._metrics(ms))

    def sync_step(self, state: dict[str, Any]) -> dict[str, Any]:
        """The parameter average: over the pods under pod-local SGD (one row
        each; all W workers when there is one pod), over the workers'
        rows otherwise.  A churn cell runs :meth:`_churn_sync`."""
        across_pods = self.comm.pod_local and self.pods > 1
        with comms.ranks(self.ranks):
            if churn_enabled(self.comm):
                return self._churn_sync(state, across_pods)
        plist = leaves(state["params"])
        with comms.ranks(self.ranks), comms.over(("pod",) if across_pods else self.data_axes):
            for m in range(self.model):  # each shard's local leaves, replicated ones once
                with comms.muted(m > 0):
                    sync.average_params(self.local_leaves(plist, m, 1, replicated=False),
                                        impl=self.comm.collective,
                                        copies=1 if across_pods else self.n_workers // self.rows)
        return state

    def _churn_sync(self, state: dict[str, Any], across_pods: bool) -> dict[str, Any]:
        """The reference's masked sync round.  The unit is the parameter
        row: a worker under local and post-local SGD (its bit drawn at the
        trainer step, as its train step's), a pod under pod-local SGD
        (alive when any of its workers was alive in the last in-pod round,
        a booked scalar psum over ``data``).  Dead rows freeze, live rows
        adopt the live average; ``pull_avg`` keeps a rejoiner out of the
        donors.  Integrity (local and post-local SGD; pod-local SGD corrupts
        its in-pod rounds instead): each worker's wire copy of its
        parameters is corrupted where flagged and validated, an invalid copy
        leaves the donors, and the bounded quarantine escalates into the
        reset.  Under the model axis the unit's payload spans its M shards:
        each shard validates its own local leaves, and any invalid slice
        invalidates the whole unit (the reference's scalar psum of 1 - valid
        over ``model``).  The rejoiners' (and escalations') EF and momentum
        rows reset.  Over ranks every bit, payload and tally is the rank's
        own rows (of its workers, or pod-local SGD's one pod row at one pod,
        whose bit the psum of the workers' bits moves in)."""
        comm, cstate, W, rows, M = self.comm, state["comm"], self.n_workers, self.rows, self.model
        held = self.held_rows
        plist = leaves(state["params"])
        locs = [self.local_leaves(plist, m, 1, replicated=False) for m in range(M)]
        valid, payloads = None, [None] * M
        if comm.pod_local:
            D = W // rows
            with comms.over(("data",)):  # the shard bits' psum, untagged as there
                comms.book_psum(cstate["alive_prev"][0], D)
            bits = comms.fill_rows(comms.worker_stack(cstate["alive_prev"][:, None]))[:, 0]
            alive = torch.where(bits.view(rows, D, M)[:, :, 0].sum(1) > 0, 1.0, 0.0)
            pod_prev = cstate["pod_alive_prev"].view(held, -1)
            prev = pod_prev[:, 0].clone()
            pod_prev.copy_(alive[:, None].expand_as(pod_prev))
            rejoined = alive * (1.0 - prev)
        else:
            alive, rejoined, window, u_corr = self._step_mask(state)
        # pull_avg: the donors are the rows alive this round and the last
        donor = alive - rejoined if comm.rejoin_policy == "pull_avg" else None
        kind = effective_corruption_kind(comm)
        if kind != "none" and not comm.pod_local:
            flag = aggregate.corruption_flags(comm, u_corr, alive, window)[:, None]

            def payload_of(loc):  # worker w's wire copy of shard-local leaf i
                return lambda i: integrity.corrupt_dense(kind, loc[i].reshape(held, -1), flag)

            payloads = [payload_of(loc) for loc in locs]
            valid = torch.ones(held, dtype=f32, device=self.device)
            for loc, payload in zip(locs, payloads):
                for i in range(len(loc)):
                    valid = valid * integrity.dense_valid(payload(i), per_row=True)
            with comms.over(("model",)):  # the validity vote over the unit's shards
                comms.book_psum(valid[0], M)
            donor = (alive if donor is None else donor) * valid
        with comms.over(("pod",) if across_pods else self.data_axes):
            for m, (loc, payload) in enumerate(zip(locs, payloads)):
                with comms.muted(m > 0):  # each shard's local leaves, replicated ones once
                    sync.average_params(loc, impl=comm.collective, alive=alive, donor=donor,
                                        payload=payload, copies=1 if across_pods else W // rows)
        if valid is not None:  # the bounded quarantine, escalating into the reset
            aggregate.quarantine_update(comm, cstate, alive.repeat_interleave(M),
                                        valid.repeat_interleave(M))
        aggregate.reset_rows(cstate, self._own_worker_bits(rejoined).repeat_interleave(M))
        return state

    def gossip_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                    lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        with comms.ranks(self.ranks):
            return self._gossip_step(state, batch, lr)

    def _gossip_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                     lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        params, parts, ms = state["params"], self._split(batch), []

        def grads_of(w):
            grads, m = self._grads(self._worker_params(params, w), parts[w - self.workers.start],
                                   1)
            ms.append(m)
            return grads

        opt_state = self._update(state["opt"], params, grads_of, lr)
        comm, cstate, step = self.comm, state["comm"], state["step"]
        # the cell's compressor, not the buckets' rules, as in the reference
        comp = get_compressor(comm.compressor, **comm.compressor_kwargs)
        choco = comm.gossip_compress == "choco" and comp is not None
        knobs = self.bucket_plan.knob_values()
        pl = leaves(params)
        alive = rejoined = nbr = None
        if churn_enabled(comm):  # each worker's bit for this mixing round
            alive, rejoined, _, _ = self._step_mask(state)
        # bucket by bucket: one (W, n) f32 stack at a time (the largest is 2.5 GB;
        # over ranks the rank's own rows);
        # under the model axis shard by shard, last to first: only shard 0
        # writes the replicated leaves, so every shard reads them unmixed
        with comms.tag("gossip_mix"), comms.over(self.data_axes), torch.no_grad():
            if alive is not None:  # the neighbours' bits, exchanged once a round
                nbr = (gossip.choco_nbr_bits(alive, rejoined) if choco
                       else gossip.ring_bits(alive))
            for m in reversed(range(self.model)):
                loc = self.local_leaves(pl, m, 1)
                cst = aggregate.shard_view(cstate, m, self.model)
                with comms.muted(m > 0):
                    for i, b in enumerate(self.bucket_plan.buckets):
                        parts_i = [loc[j].reshape(loc[j].shape[0], -1).to(f32)
                                   for j, _ in b.segments]
                        x = parts_i[0] if len(parts_i) == 1 else torch.cat(parts_i, 1)
                        del parts_i
                        if choco:
                            st = gossip.ChocoState([cst["choco_xhat"][i]], [cst["choco_nbr"][i]])
                            (x,), _ = gossip.choco_mix(
                                comm, comp, lambda _, n, i=i: self.noise(step, None, i, n), [x],
                                st, comm.gossip_mix_weight, comp_knobs=(knobs[i],), alive=alive,
                                rejoined=rejoined, nbr_bits=nbr)
                        else:
                            (x,) = gossip.dpsgd_mix(
                                [x], comm.gossip_mix_weight, alive=alive,
                                rejoined=rejoined if comm.rejoin_policy == "pull_avg" else None,
                                nbr_alive=nbr)
                        off = 0
                        for j, n in b.segments:
                            if m == 0 or self.shard_dims[j] is not None:
                                loc[j].copy_(x[:, off:off + n].reshape(loc[j].shape))
                            off += n
                        del x
        cstate["step"] += 1
        return ({"params": params, "opt": opt_state, "comm": cstate, "step": step + 1},
                self._metrics(ms))

    def eval_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor], *,
                  metrics: bool = False) -> Any:
        """The worker mean of each worker's forward loss on its rows (with
        ``metrics``: ``(loss, {"ce", "aux"})``, each a worker mean)."""
        with torch.no_grad():
            outs = [T.forward_loss(self.cfg, self._worker_params(state["params"], w, False), part,
                                   msize=self.model)
                    for w, part in zip(self.workers, self._split(batch))]
        with comms.ranks(self.ranks):
            loss = comms.pmean(self._worker_stack([o[0] for o in outs]))
            if not metrics:
                return loss
            return loss, {k: comms.pmean(self._worker_stack([o[1][k] for o in outs]))
                          for k in ("ce", "aux")}


def _book_wire(bundle: StepBundle) -> dict[str, comms.CommLog]:
    """Run each program of the scheme once on the meta device (no memory,
    no arithmetic) under a comms capture: "train" (not for gossip, which
    never calls it), "inner" under local and post-local SGD, "sync" under
    those and pod-local SGD, "gossip" under gossip.  Recomputation is off
    there: it changes no collective.  Returns each program's records."""
    meta = torch.device("meta")
    mb = dataclasses.replace(bundle, cfg=bundle.cfg.with_updates(remat="none"), device=meta,
                             noise=aggregate.seeded_noise(0, meta),
                             churn_draws=aggregate.seeded_churn_draws(0, meta), ranks=None)
    shape, comm = bundle.shape, bundle.comm
    batch = {k: torch.zeros(shp, dtype=torch.from_numpy(np.empty(0, dt)).dtype, device=meta)
             for k, (shp, dt) in input_specs(bundle.cfg, shape).items()}
    programs = {}
    if comm.aggregator == "gossip":
        programs["gossip"] = lambda st: mb.gossip_step(st, batch, 0.0)
    else:
        programs["train"] = lambda st: mb.train_step(st, batch, 0.0)
        if comm.sync in ("local", "post_local"):
            programs["inner"] = lambda st: mb.inner_step(st, batch, 0.0)
        if comm.sync in ("local", "post_local") or comm.pod_local:
            programs["sync"] = mb.sync_step
    logs = {}
    for name, run in programs.items():
        mb._meta_grads = {}  # each program books its own forward collectives
        state = mb._meta_state()
        with comms.capture() as logs[name]:
            run(state)
    return logs


@dataclass
class BundleCacheStats:
    """Builds and hits of the bundle registry (the trainer sweeps assert
    builds <= shape classes)."""

    builds: int = 0
    hits: int = 0

    @property
    def persistent_cache(self) -> dict:
        """The manifest's hits and misses of fresh builds, at bundle-key
        granularity (:mod:`repro_torch.core.compilecache`)."""
        from repro_torch.core import compilecache

        return compilecache.record("bundle")


def _save_logs(logs: dict[str, comms.CommLog]) -> dict:
    """The wire artifact: each program's booked records as JSON."""
    return {name: [dataclasses.asdict(r) for r in log.records] for name, log in logs.items()}


def _load_logs(art: dict) -> dict[str, comms.CommLog]:
    return {name: comms.CommLog([comms.CollRecord(**{**r, "axes": tuple(r["axes"])})
                                 for r in recs]) for name, recs in art.items()}


@dataclass(frozen=True)
class _SharedBuild:
    """The knob-independent half of a build, shared by the cells of a shape
    class: each program's booked records (the meta-device run of
    :func:`_book_wire`) and the wire by tag and format derived from them.
    The bucket plan's layout is in the registry key.  Nothing here holds a
    value knob: each cell's bundle carries its own ``comm`` and bucket plan,
    which the steps read at run time."""

    logs: dict[str, comms.CommLog]
    wire: dict[str, dict[str, float]]


_BUNDLE_STATS = BundleCacheStats()
_BUNDLE_CACHE: dict[tuple, _SharedBuild] = {}
_BUNDLE_CACHE_CAP = 32


def bundle_cache_stats() -> BundleCacheStats:
    return _BUNDLE_STATS


def bundle_cache_clear() -> None:
    """Drop every shared build and zero the counters."""
    _BUNDLE_CACHE.clear()
    _BUNDLE_STATS.builds = 0
    _BUNDLE_STATS.hits = 0


def bundle_cache_key(cfg: ModelConfig, spec: BundleSpec, plan: aggregate.BucketPlan,
                     opt: Optimizer, shape: InputShape, *, n_workers: int, pods: int,
                     clip_norm: float, microbatch: int, model: int = 1) -> tuple:
    """The registry key (the reference's ``bundle_cache_key``): the model
    config, the worker layout (the reference's mesh), the structural
    :class:`BundleSpec`, the bucket plan's signature, the optimizer, the
    input shape and the structural build flags.  The seed, lr,
    ``clip_norm``'s value and every value knob are absent."""
    return (repr(cfg), n_workers, pods, model, spec, aggregate.plan_signature(plan),
            (opt.name, opt.n_shards), shape, bool(clip_norm), int(microbatch))


def check_ranks(comm: CommConfig, n_workers: int, pods: int, model: int,
                group: RankGroup | None) -> None:
    """Refuse, with the later slice that brings it (``ROADMAP.md`` Queue
    1), what ranks on the data axis do not run yet: the model and pod axes
    (pod-local SGD over several pods among them).  They run BSP, local,
    post-local and pod-local SGD at one pod, D-PSGD and CHOCO-SGD, under
    the sequential and the pipelined step, with churn and integrity."""
    if group is None:
        return
    if group.n_workers != n_workers:
        raise ValueError(f"the rank group splits {group.n_workers} workers, the bundle has "
                         f"{n_workers}")
    if model > 1 or pods > 1:
        raise ValueError("the model and pod axes over ranks: a later slice (ROADMAP.md Queue "
                         "1, slice 26); ranks run on the data axis alone")


def build_bundle(cfg: ModelConfig, comm: CommConfig, opt: Optimizer, shape: InputShape, *,
                 n_workers: int = 1, seed: int = 0, device: str | torch.device = "cuda",
                 noise: aggregate.Noise | None = None, clip_norm: float = 0.0,
                 microbatch: int = 1, pods: int = 1, model: int = 1,
                 churn_draws: aggregate.ChurnDraws | None = None,
                 cache: bool = True, ranks: RankGroup | None = None) -> StepBundle:
    """Build the steps of one cell.  ``noise(step, worker, bucket, n)``
    overrides the compressors' uniform draws (default: a generator seeded
    from (seed, step, worker, bucket) on ``device``; worker None for
    CHOCO-SGD's draw, which every worker shares; a pipelined round passes
    its index as a fifth argument); ``clip_norm > 0`` clips the aggregated
    gradient (each worker's own on an inner step) to that global norm
    before the update, as the reference's step does; ``microbatch`` splits
    each worker's rows into that many accumulated chunks (the pipelined
    step's microbatches); ``pods`` P lays the W workers out as (pod, data),
    W = P * D (0 and 1: no pod axis); ``churn_draws(step, worker[, round])``
    overrides a churn cell's two uniforms per worker and round (default: a
    generator seeded from (seed, step, worker, round) on ``device``);
    ``model`` M is the model axis's size: the parameters are the
    padded-for-M tree (``T.init_params(cfg, seed, device, M)``), the W * M
    (worker, shard) pairs each aggregate their shard-local buckets;
    ``ranks`` is this process's rank of the data axis (its workers run
    here, the others in the group's other processes; :func:`check_ranks`).

    The cells of one shape class (:func:`bundle_cache_key`) share the
    knob-independent half of the build through the bundle registry: the
    booked wire of :func:`_book_wire`.  Each cell binds its own value knobs,
    as the reference's ``BoundStep`` binds a ``CommKnobs`` tree: the bundle
    holds this cell's ``comm``, bucket plan (its compressors' kwargs),
    noise and churn draws.  ``cache=False`` forces a fresh build (the
    per-cell baseline the trainer sweep measures against)."""
    spec = bundle_spec(comm)  # validates comm
    pods = max(pods, 1)
    if n_workers % pods:
        raise ValueError(f"{n_workers} workers do not split into {pods} pods")
    if opt.n_shards and opt.n_shards != n_workers:
        raise ValueError(f"{opt.name} shards its state over {opt.n_shards} workers, "
                         f"the bundle has {n_workers}")
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    if comm.worker_dropout and len(comm.worker_dropout) != n_workers:
        raise ValueError(f"worker_dropout has {len(comm.worker_dropout)} rates but the bundle "
                         f"has {n_workers} workers")
    device = torch.device(device)
    if model < 1:
        raise ValueError(f"model must be >= 1, got {model}")
    check_ranks(comm, n_workers, pods, model, ranks)
    defs = T.param_defs(cfg, model)
    plan = aggregate.make_bucket_plan(comm, local_defs(defs, model))
    if model > 1 and opt.n_shards:
        opt = opt.for_model(shard_dims(defs), model)
    bundle = StepBundle(
        cfg=cfg, comm=comm, shape=shape, n_workers=n_workers, device=device,
        bucket_plan=plan, opt=opt, model=model, shard_dims=tuple(shard_dims(defs)),
        noise=noise if noise is not None else aggregate.seeded_noise(seed, device),
        clip_norm=clip_norm, microbatch=microbatch, pods=pods,
        churn_draws=(churn_draws if churn_draws is not None
                     else aggregate.seeded_churn_draws(seed, device)), ranks=ranks,
    )
    key = bundle_cache_key(cfg, spec, plan, opt, shape, n_workers=n_workers, pods=pods,
                           clip_norm=clip_norm, microbatch=microbatch, model=model)
    shared = _BUNDLE_CACHE.get(key) if cache else None
    if shared is None:
        from repro_torch.core import compilecache

        # a warm persistent cache holds this class's booked records: load
        # them and skip the meta-device trace.  cache=False is the per-cell
        # baseline and pays the full build, so it neither reads nor writes
        # the artifact nor the manifest.
        path = compilecache.wire_path("bundle", key) if cache else None
        art = compilecache.load_json(path)
        if art is None:
            logs = _book_wire(bundle)
            compilecache.save_json(path, _save_logs(logs))
        else:
            logs = _load_logs(art)
        if cache:
            compilecache.record_compile("bundle", key)
        wire = {}
        for name, log in logs.items():
            # the formats leave out the churn_resync channel, as the reference's
            wire[name] = log.by_tag()
            wire[name + "_formats"] = log.by_wire_format(exclude_tags=("churn_resync",))
        shared = _SharedBuild(logs, wire)
        _BUNDLE_STATS.builds += 1
        if cache:
            if len(_BUNDLE_CACHE) >= _BUNDLE_CACHE_CAP:
                _BUNDLE_CACHE.pop(next(iter(_BUNDLE_CACHE)))
            _BUNDLE_CACHE[key] = shared
    else:
        _BUNDLE_STATS.hits += 1
    bundle.logs = dict(shared.logs)
    bundle.wire = {k: dict(v) for k, v in shared.wire.items()}
    return bundle


@dataclass
class ServeBundle:
    cfg: ModelConfig
    shape: InputShape  # global_batch is the batch every call must carry
    device: torch.device
    #: (params, {"tokens" (B, S_text)[, "patches" | "frames"]}) -> (last hidden (B, d),
    #: cache)
    prefill_step: Callable
    #: (params, cache, tokens (B, 1)) -> (next tokens (B, 1) int32, new cache)
    serve_step: Callable


def build_serve(cfg: ModelConfig, shape: InputShape,
                device: str | torch.device = "cuda", msize: int = 1,
                ranks: RankGroup | None = None) -> ServeBundle:
    """Prefill and decode steps for ``cfg``, both under
    ``torch.inference_mode()``, their inputs numpy arrays or tensors (moved
    to ``device``): the prefill's ``tokens`` and, for the vision and audio
    families, its ``patches`` or ``frames``.  As the reference's
    ``build_serve``: the prefill passes no ``max_seq``, so each attention
    layer's ring holds ``min(window, prompt length)`` slots (the prompt
    counting its patches) and the first decoded token evicts the oldest
    position of a full ring; decode runs with ``max_seq = shape.seq_len``.
    ``serve_step`` writes the new token's ring slot into the cache it is
    given: that cache is consumed (the reference donates it), so use only
    the one it returns (hymba's new SSM and conv states are written into
    it too).  RWKV6 runs its recurrence through kernel ``wkv6`` (its plain
    version on the CPU).  ``msize``: the reference's model axis, stacked on
    the device: ``params`` are the padded-for-``msize`` tree and the cache
    the context-parallel one in its global layout (each ring a multiple of
    ``msize`` slots).  Under ``cfg.seq_par`` the prefill is sequence
    parallel and its rings hold the prompt, so ``shape.seq_len`` is the
    prompt too (the reference's launcher sets it so).  Serving over ranks
    (the reference's ``--data``) is a later slice: it raises for a rank
    group ``ranks``."""
    if ranks is not None:
        raise ValueError("serving over ranks (the reference's --data): a later slice "
                         "(ROADMAP.md Queue 1, slice 27)")
    T.check_serving(cfg, msize)
    device = torch.device(device)

    def _rows(a) -> torch.Tensor:
        a = torch.as_tensor(a).to(device)
        if a.shape[0] != shape.global_batch:
            raise ValueError(f"batch {a.shape[0]} != the bundle's {shape.global_batch}")
        return a

    def prefill_step(params, batch):
        with torch.inference_mode():
            return T.prefill(cfg, params, {k: _rows(v) for k, v in batch.items()},
                             use_kernel=True, msize=msize)

    def serve_step(params, cache, tok):
        with torch.inference_mode():
            return T.decode_step(cfg, params, cache, _rows(tok), max_seq=shape.seq_len,
                                 use_kernel=True, inplace=True, msize=msize)

    return ServeBundle(cfg=cfg, shape=shape, device=device, prefill_step=prefill_step,
                       serve_step=serve_step)
