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
disagree there: their buckets' scales differ).  ``clip_norm`` takes the
norm of the global gradient: the sharded leaves summed over the shards,
the replicated ones once.  ZeRO-1 slices each shard-local leaf over the
data workers.  The sync and gossip steps average or mix each shard's
local leaves over the data axes, shard by shard.  Churn, integrity,
PowerSGD and the pipelined step do not run under the model axis yet.

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
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import aggregate, comms, gossip, integrity, sync
from repro_torch.core.compression.base import get_compressor
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
from repro_torch.optim.optimizers import Optimizer, global_clip
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
    #: the pipelined step's side stream on the card (made at first use)
    _side: Any = field(default=None, repr=False, compare=False)
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
                return torch.stack([p] * self.rows)
            return p if self.stacked else p.requires_grad_(True)

        return tree_map(place, params)

    def init_state(self, params: Any) -> dict[str, Any]:
        """The step state from one parameter tree (every worker starts from
        it)."""
        params = self._place(params, stack=self.stacked)
        sharded = self.stacked and self.opt.n_shards  # zero1's slices of one row
        return {
            "params": params,
            "opt": self.opt.init(tree_map(lambda p: p[0], params) if sharded else params),
            "comm": aggregate.init_comm_state(self.comm, self.bucket_plan,
                                              self.n_workers, self.device, self.pods,
                                              self.model),
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
        ``quarantine_total``, ``escalation_total``) are (W,) here as there.
        Diverging parameters keep their rows (W, or P under pod-local SGD).
        Under the model axis the parameters are the global tree and every
        per-worker entry has one row per (worker, shard), in the
        reference's device order.  Views where it can."""
        W, defs = self.n_workers * self.model, T.param_defs(self.cfg, self.model)
        n_leaves = len(leaves(defs))

        def opt_ref(x):
            if isinstance(x, dict):
                return {k: opt_ref(v) for k, v in x.items()}
            if isinstance(x, list) and len(x) == n_leaves:
                return unflatten_like(defs, [t.reshape(-1) if self.opt.n_shards else t
                                             for t in x])
            return x

        comm = dict(state["comm"])
        for k in aggregate.COMM_STACKS:
            if k in comm:
                comm[k] = [torch.zeros(W * b.size, dtype=f32, device=self.device)
                           if e is None else e.reshape(-1)
                           for e, b in zip(comm[k], self.bucket_plan.buckets)]
        if "psgd_q" in comm:
            comm["psgd_q"] = [q.repeat(W) if q.dim() == 1 else
                              q.repeat_interleave(W // q.shape[0], 0).reshape(-1)
                              for q in comm["psgd_q"]]
        return {"params": state["params"], "opt": opt_ref(state["opt"]), "comm": comm,
                "step": state["step"]}

    def checkpoint_like(self, keys: tuple[str, ...] = ("params", "opt", "comm", "step")
                        ) -> dict[str, Any]:
        """The checkpoint layout's structure, shapes and dtypes (on the
        ``meta`` device), restricted to ``keys``: the ``like`` tree of
        ``checkpoint.restore``."""
        meta = dataclasses.replace(self, device=torch.device("meta"))
        tree = meta.checkpoint_tree(self._meta_state())
        return {k: tree[k] for k in keys}

    def _opt_from_checkpoint(self, tree: Any, tmpl: Any) -> Any:
        if isinstance(tmpl, dict):
            return {k: self._opt_from_checkpoint(tree[k], v) for k, v in tmpl.items()}
        if isinstance(tmpl, list):
            return [a.reshape(t.shape) for a, t in zip(leaves(tree), tmpl)]
        return tree

    def from_checkpoint(self, tree: dict[str, Any]) -> dict[str, Any]:
        """Inverse of :meth:`checkpoint_tree` on a tree restored from it;
        ``tree`` may hold only some of its keys (``restore_rejoin``: no
        ``comm``)."""
        tmpl = self._meta_state()
        out = {}
        if "params" in tree:
            out["params"] = self._place(tree["params"], stack=False)
        if "opt" in tree:
            out["opt"] = self._opt_from_checkpoint(tree["opt"], tmpl["opt"])
        if "comm" in tree:
            comm = dict(tree["comm"])
            for k in aggregate.COMM_STACKS:
                if k in comm:
                    comm[k] = [None if t is None else e.reshape(t.shape)
                               for e, t in zip(comm[k], tmpl["comm"][k])]
            if "psgd_q" in comm:
                comm["psgd_q"] = [q[:q.numel() // self.n_workers] if t.dim() == 1 else
                                  q.reshape(self.n_workers, -1)[::self.n_workers // t.shape[0]]
                                  for q, t in zip(comm["psgd_q"], tmpl["comm"]["psgd_q"])]
            out["comm"] = comm
        if "step" in tree:
            out["step"] = tree["step"]
        return out

    # ---- per-worker pieces ------------------------------------------------------

    def _split(self, batch: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
        B, W = batch["tokens"].shape[0], self.n_workers
        if B % W:
            raise ValueError(f"global batch {B} does not split over {W} workers")
        bl = B // W
        return [{k: v[w * bl:(w + 1) * bl] for k, v in batch.items()} for w in range(W)]

    def _worker_params(self, params: Any, w: int, grad: bool = True) -> Any:
        if not self.stacked:
            return params
        r = self.row_of(w)
        if not grad:
            return tree_map(lambda p: p[r], params)
        return tree_map(lambda p: p[r].detach().requires_grad_(True), params)

    def _grads(self, params: Any, part: dict[str, torch.Tensor], microbatch: int
               ) -> tuple[list[torch.Tensor], dict[str, torch.Tensor]]:
        """One worker's gradients (leaf order) and its loss and metrics.  On
        the meta device (the wire trace, shapes only) every worker's
        gradients have the same shapes and the model books no collective,
        so the first worker's trace stands for the rest."""
        if part["tokens"].is_meta:
            key = (part["tokens"].shape, microbatch)
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
        row in place (``grads_of(r)``, called in row order; ``zero1`` reads
        each worker's slice of its own row); a 0-dim state leaf (adamw's
        ``t``) advances once, as each row's update returns the same value.
        ``zero1``'s all-gather is booked over every data axis."""
        pleaves = leaves(params)
        if not self.stacked:
            with comms.over(self.data_axes):
                return self.opt.update(grads_of(0), opt_state, pleaves, lr)[1]
        if self.opt.update_rows is not None:
            with comms.over(self.data_axes):
                return self.opt.update_rows(grads_of, opt_state, pleaves, lr, self.row_of)
        new = opt_state
        for r in range(self.rows):
            rows = tree_map(lambda x: x[r] if isinstance(x, torch.Tensor) and x.ndim else x,
                            opt_state)
            new = self.opt.update(grads_of(r), rows, [p[r] for p in pleaves], lr)[1]
        return unflatten_like(opt_state, [o if o.ndim else n for o, n in
                                          zip(leaves(opt_state), leaves(new))])

    def _metrics(self, ms: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
        with comms.over(self.data_axes):
            return {k: comms.pmean(torch.stack([m[k] for m in ms]))
                    for k in ("loss", "ce", "aux")}

    def _round(self, state: dict[str, Any], rnd: int | None = None,
               live: aggregate.Liveness | None = None) -> aggregate.ShardedRound:
        return aggregate.ShardedRound(self.comm, self.bucket_plan, state["comm"],
                                      self.n_workers, self.noise, self.device,
                                      shards=self.model, step=state["step"], rnd=rnd,
                                      groups=self.groups, live=live,
                                      churn_draws=self.churn_draws)

    def _step_mask(self, state: dict[str, Any]) -> tuple:
        """One participation bit per worker for a whole step (the sync,
        gossip and staleness-1 pipelined steps), drawn and windowed at the
        trainer step, with no round index (:func:`aggregate.draw_mask`)."""
        return aggregate.draw_mask(self.comm, state["comm"], self.churn_draws, state["step"],
                                   state["step"], self.n_workers, self.device)

    def _sequential_grads(self, state: dict[str, Any], parts: list[dict[str, torch.Tensor]]
                          ) -> tuple[list[list[torch.Tensor]], list[dict], Any]:
        """Every worker's (microbatch-accumulated) gradient through one
        round: returns the per-shard lists of per-group bucket aggregates,
        the per-worker metrics and the round."""
        rnd, ms = self._round(state), []
        for w, part in enumerate(parts):
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

    def _pipelined_grads(self, state: dict[str, Any], parts: list[dict[str, torch.Tensor]]
                         ) -> tuple[list[list[torch.Tensor]], list[dict], Any]:
        """The reference's ``_pipelined_grads``: round k aggregates the f32
        bucket gradients of the microbatch before k (``pending``, (W, size)
        per bucket) while microbatch k's forward and backward run; returns
        the per-group sum_k scale_k agg_k / M, the per-worker metrics (means
        over the microbatches) and the kept-element counts.

        On the card each round runs on the side stream after the main
        stream's work so far (the microbatch that filled ``pending``);
        worker w's rows of ``pending`` are refilled only after the event
        recorded when the round's send side has read them, and the main
        stream waits for the last round before it reads the sums.  The
        buffers the side stream touches (``pending``, the sums, the comm
        state) are held until then; the round's own temporaries live in the
        side stream's pool, which every round enters after the main stream.
        Each round keys its noise with its index; the M rounds are booked
        once under ``comms.loop``, as the reference books its scan."""
        comm, plan, M, W = self.comm, self.bucket_plan, self.microbatch, self.n_workers
        params, dev = state["params"], self.device
        rows = parts[0]["tokens"].shape[0]
        if rows % M:
            raise ValueError(f"local batch {rows} does not split into {M} microbatches")
        mb, side = rows // M, self._side_stream()
        acc = [[torch.zeros(b.size, dtype=f32, device=dev) for b in plan.buckets]
               for _ in range(self.groups)]
        ms: list[list[dict[str, torch.Tensor]]] = [[] for _ in range(W)]
        kept = {"nnz": None, "of": 0}

        def fill(j: int, freed: list | None) -> None:
            """Microbatch j of every worker into ``pending``, worker w's
            rows once ``freed[w]`` has passed."""
            for w, part in enumerate(parts):
                pw = self._worker_params(params, w)
                loss, m = T.forward_loss(self.cfg, pw, {k: v[j * mb:(j + 1) * mb]
                                                        for k, v in part.items()})
                grads = torch.autograd.grad(loss, leaves(pw))
                if freed is not None and freed[w] is not None:
                    torch.cuda.current_stream(dev).wait_event(freed[w])
                with torch.no_grad():
                    for i, b in enumerate(plan.buckets):  # f32 widening, as gather_bucket
                        off = 0
                        for li, n in b.segments:
                            pending[i][w, off:off + n].copy_(grads[li].reshape(-1))
                            off += n
                del grads
                ms[w].append({"loss": loss.detach(), **{k: v.detach() for k, v in m.items()}})

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
                _, u_corr = aggregate.draw_uniforms(self.churn_draws, state["step"], range(W),
                                                    k, dev)
                flag = aggregate.corruption_flags(comm, u_corr, a_k, window)
            return aggregate.Liveness(a_k, rejoined if k == 0 else None, flag, kind)

        def run_round(k: int, scale: float):
            """Round k over ``pending``, its aggregates (times ``scale``)
            added into ``acc``; returns the per-worker events and the last."""
            if side is not None:
                side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
                rnd, freed = self._round(state, rnd=k, live=live_of(k)), []
                for w in range(W):
                    rnd.add(w, lambda m, w=w: [p[w] for p in pending])
                    freed.append(side.record_event() if side is not None else None)
                aggs = rnd.finish()[0][0]
                s = torch.full((), scale, dtype=f32, device=dev)
                for acc_g, agg_g in zip(acc, aggs):
                    for a, x in zip(acc_g, agg_g):
                        a.add_(x * s)
                del aggs
                if rnd.nnz is not None:
                    kept["nnz"] = rnd.nnz if kept["nnz"] is None else kept["nnz"] + rnd.nnz
                    kept["of"] += rnd.nnz_of
                return freed, (side.record_event() if side is not None else None)

        if comm.overlap_staleness == 1:
            pending = state["comm"]["overlap_pending"]
            with comms.loop(M):
                for k in range(M):
                    with comms.muted(k > 0):
                        freed, done = run_round(k, comm.stale_scale if k == 0 else 1.0)
                    fill(k, freed)
        else:
            pending = [torch.empty((W, b.size), dtype=f32, device=dev) for b in plan.buckets]
            fill(0, None)
            with comms.loop(M - 1):
                for k in range(M - 1):
                    with comms.muted(k > 0):
                        freed, done = run_round(k, 1.0)
                    fill(k + 1, freed)
            freed, done = run_round(M - 1, 1.0)  # the flush
        if done is not None:
            torch.cuda.current_stream(dev).wait_event(done)
        del pending
        metrics = [{k: torch.mean(torch.stack([d[k] for d in mw])) for k in mw[0]} for mw in ms]
        return [[a / M for a in acc_g] for acc_g in acc], metrics, kept

    # ---- the programs -------------------------------------------------------------

    def train_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                   lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        params, plan, parts = state["params"], self.bucket_plan, self._split(batch)
        with comms.over(self.agg_axes):
            if self.comm.overlap == "pipelined":
                aggs, ms, kept = self._pipelined_grads(state, parts)
                aggs, nnz, nnz_of = [aggs], kept["nnz"], kept["of"]
            else:
                aggs, ms, rnd = self._sequential_grads(state, parts)
                nnz, nnz_of = rnd.nnz, rnd.nnz_of
        like = [p[0] for p in leaves(params)] if self.stacked else leaves(params)
        # one aggregate per pod under pod-local SGD (row r is pod r), else
        # one; aggs[m][g] is shard m's of group g
        grads = [global_clip(self._scatter([a[g] for a in aggs], like), self.clip_norm)
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
        params, parts, ms = state["params"], self._split(batch), []

        def grads_of(w):
            grads, m = self._grads(self._worker_params(params, w), parts[w], self.microbatch)
            ms.append(m)
            return global_clip(grads, self.clip_norm)

        opt_state = self._update(state["opt"], params, grads_of, lr)
        return ({"params": params, "opt": opt_state, "comm": state["comm"],
                 "step": state["step"] + 1}, self._metrics(ms))

    def sync_step(self, state: dict[str, Any]) -> dict[str, Any]:
        """The parameter average: over the pods under pod-local SGD (one row
        each; all W workers when there is one pod), over the workers'
        rows otherwise.  A churn cell runs :meth:`_churn_sync`."""
        across_pods = self.comm.pod_local and self.pods > 1
        if churn_enabled(self.comm):
            return self._churn_sync(state, across_pods)
        plist = leaves(state["params"])
        with comms.over(("pod",) if across_pods else self.data_axes):
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
        reset.  The rejoiners' (and escalations') EF and momentum rows
        reset."""
        comm, cstate, W, rows = self.comm, state["comm"], self.n_workers, self.rows
        plist = leaves(state["params"])
        valid = payload = None
        if comm.pod_local:
            D = W // rows
            with comms.over(("data",)):  # the shard bits' psum, untagged as there
                comms.book_psum(cstate["alive_prev"][0], D)
            alive = torch.where(cstate["alive_prev"].reshape(rows, D).sum(1) > 0, 1.0, 0.0)
            prev = cstate["pod_alive_prev"].reshape(rows, D)[:, 0].clone()
            cstate["pod_alive_prev"].copy_(alive.repeat_interleave(D))
            rejoined = alive * (1.0 - prev)
        else:
            alive, rejoined, window, u_corr = self._step_mask(state)
        # pull_avg: the donors are the rows alive this round and the last
        donor = alive - rejoined if comm.rejoin_policy == "pull_avg" else None
        kind = effective_corruption_kind(comm)
        if kind != "none" and not comm.pod_local:
            flag = aggregate.corruption_flags(comm, u_corr, alive, window)

            def payload(i: int) -> torch.Tensor:  # worker w's wire copy of leaf i
                p = plist[i]
                return integrity.corrupt_dense(kind, p.reshape(W, -1).to(f32), flag[:, None])

            valid = torch.ones(W, dtype=f32, device=self.device)
            for i in range(len(plist)):
                valid = valid * integrity.dense_valid(payload(i), per_row=True)
            with comms.over(("model",)):  # the validity vote over the unit's shards
                comms.book_psum(valid[0], 1)
            donor = (alive if donor is None else donor) * valid
        with comms.over(("pod",) if across_pods else self.data_axes):
            sync.average_params(plist, impl=comm.collective, alive=alive, donor=donor,
                                payload=payload, copies=1 if across_pods else W // rows)
        if valid is not None:  # the bounded quarantine, escalating into the reset
            aggregate.quarantine_update(comm, cstate, alive, valid)
        aggregate.reset_rows(cstate, rejoined.repeat_interleave(W // rows))
        return state

    def gossip_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                    lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        params, parts, ms = state["params"], self._split(batch), []

        def grads_of(w):
            grads, m = self._grads(self._worker_params(params, w), parts[w], 1)
            ms.append(m)
            return grads

        opt_state = self._update(state["opt"], params, grads_of, lr)
        comm, cstate, step, W = self.comm, state["comm"], state["step"], self.n_workers
        # the cell's compressor, not the buckets' rules, as in the reference
        comp = get_compressor(comm.compressor, **comm.compressor_kwargs)
        choco = comm.gossip_compress == "choco" and comp is not None
        knobs = self.bucket_plan.knob_values()
        pl = leaves(params)
        alive = rejoined = nbr = None
        if churn_enabled(comm):  # each worker's bit for this mixing round
            alive, rejoined, _, _ = self._step_mask(state)
        # bucket by bucket: one (W, n) f32 stack at a time (the largest is 2.5 GB);
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
                        parts_i = [loc[j].reshape(W, -1).to(f32) for j, _ in b.segments]
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
                    for w, part in enumerate(self._split(batch))]
        loss = comms.pmean(torch.stack([o[0] for o in outs]))
        if not metrics:
            return loss
        return loss, {k: comms.pmean(torch.stack([o[1][k] for o in outs])) for k in ("ce", "aux")}


def _book_wire(bundle: StepBundle) -> dict[str, comms.CommLog]:
    """Run each program of the scheme once on the meta device (no memory,
    no arithmetic) under a comms capture: "train" (not for gossip, which
    never calls it), "inner" under local and post-local SGD, "sync" under
    those and pod-local SGD, "gossip" under gossip.  Recomputation is off
    there: it changes no collective.  Returns each program's records."""
    meta = torch.device("meta")
    mb = dataclasses.replace(bundle, cfg=bundle.cfg.with_updates(remat="none"), device=meta,
                             noise=aggregate.seeded_noise(0, meta),
                             churn_draws=aggregate.seeded_churn_draws(0, meta))
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


def build_bundle(cfg: ModelConfig, comm: CommConfig, opt: Optimizer, shape: InputShape, *,
                 n_workers: int = 1, seed: int = 0, device: str | torch.device = "cuda",
                 noise: aggregate.Noise | None = None, clip_norm: float = 0.0,
                 microbatch: int = 1, pods: int = 1, model: int = 1,
                 churn_draws: aggregate.ChurnDraws | None = None,
                 cache: bool = True) -> StepBundle:
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
    (worker, shard) pairs each aggregate their shard-local buckets.

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
    defs = T.param_defs(cfg, model)
    plan = aggregate.make_bucket_plan(comm, local_defs(defs, model))
    if model > 1:
        _check_model_axis(cfg, comm, opt, plan, param_rows(comm, n_workers, pods))
        if opt.n_shards:
            opt = opt.for_model(shard_dims(defs), model)
    bundle = StepBundle(
        cfg=cfg, comm=comm, shape=shape, n_workers=n_workers, device=device,
        bucket_plan=plan, opt=opt, model=model, shard_dims=tuple(shard_dims(defs)),
        noise=noise if noise is not None else aggregate.seeded_noise(seed, device),
        clip_norm=clip_norm, microbatch=microbatch, pods=pods,
        churn_draws=(churn_draws if churn_draws is not None
                     else aggregate.seeded_churn_draws(seed, device)),
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


def _check_model_axis(cfg: ModelConfig, comm: CommConfig, opt: Optimizer,
                      plan: aggregate.BucketPlan, rows: int) -> None:
    """Raise for the options that do not train under the model axis yet."""
    if cfg.seq_par:
        raise NotImplementedError(f"{cfg.name}: seq_par under the model axis is slice 20 "
                                  "(serving on the model axis)")
    if churn_enabled(comm):
        raise NotImplementedError("churn and integrity under the model axis are not ported")
    if comm.overlap == "pipelined":
        raise NotImplementedError("the pipelined step under the model axis is not ported")
    if any(b.compressor_name == "powersgd" for b in plan.buckets):
        raise NotImplementedError("PowerSGD under the model axis is not ported")
    if opt.n_shards and rows:
        raise NotImplementedError(f"{opt.name} with diverging parameter rows under the model "
                                  "axis is not ported")


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
                device: str | torch.device = "cuda", msize: int = 1) -> ServeBundle:
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
    version on the CPU).  ``msize`` other than 1 raises: serving under the
    model axis is slice 20."""
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
                             use_kernel=True)

    def serve_step(params, cache, tok):
        with torch.inference_mode():
            return T.decode_step(cfg, params, cache, _rows(tok), max_seq=shape.seq_len,
                                 use_kernel=True, inplace=True)

    return ServeBundle(cfg=cfg, shape=shape, device=device, prefill_step=prefill_step,
                       serve_step=serve_step)
