"""Step builder: model, gradient exchange or parameter mixing, and optimizer
for W data-parallel workers stacked on one device (counterpart of
``repro.train.steps``: ``build_bundle`` with its ``train_step``,
``inner_step``, ``sync_step``, ``gossip_step`` and ``eval_step``,
sequential overlap).

A step splits the global batch into W contiguous row blocks (the
reference's batch sharding over ``data``) and runs the workers in turn.

* **Parameters.**  Under BSP every worker applies the same aggregate, so
  the W workers share one parameter tree.  Under local SGD, post-local SGD
  and gossip their parameters diverge: each leaf, and each optimizer-state
  leaf, carries a leading worker axis (W, *shape), as each shard of the
  reference holds its own copy.  Worker w runs forward and backward on a
  detached view of row w that requires grad (no (W, ...) gradient is ever
  formed), and the optimizer updates row w in place.
* **Microbatching** (``microbatch`` M > 1, the reference's
  ``_sequential_grads``): each worker's rows are split into M chunks whose
  raw gradients are accumulated in f32, then (acc / M) is cast back to the
  parameter dtype; loss and metrics are the chunks' means.  The gossip step
  takes the gradient of the worker's whole rows, as the reference's does.
* **train_step** (BSP, and post-local SGD's aggregating steps): each
  worker's gradient goes, bucket by bucket, to the send side of an
  :class:`AggregationRound` (momentum, clipping and error feedback, then
  compression into that worker's row of the wire stack); the receive side
  reduces every bucket, ``clip_norm`` (if set) clips the aggregate to that
  global norm, and the optimizer applies it (to every worker's row when
  the parameters are stacked).  ``kept`` is the share of elements that the
  masked sparsifiers kept this step, over all workers and their buckets.
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

Loss, ``ce`` and ``aux`` are worker means.  The wire bytes of each program
are booked at build time by running it once on the ``meta`` device, which
computes shapes only.

``build_serve`` is the serving counterpart (``ServeBundle``: prefill a batch
of prompts, then one greedy token per call), for the RWKV6 family; one card
is one device, so there is no mesh.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import aggregate, comms, gossip, sync
from repro_torch.core.compression.base import get_compressor
from repro_torch.core.types import CommConfig, validate
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer, global_clip
from repro_torch.utils.tree import leaves, tree_map, unflatten_like

f32 = torch.float32

#: the per-worker (W, size) comm-state stacks, one per bucket
_COMM_STACKS = ("ef", "u", "choco_xhat", "choco_nbr")


def stacked_params(comm: CommConfig) -> bool:
    """Do the workers' parameters diverge (one (W, *shape) row each)?"""
    return comm.sync in ("local", "post_local") or comm.aggregator == "gossip"


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
    #: gradient-accumulation chunks per worker and step
    microbatch: int = 1
    #: per-call wire bytes of each program, booked from one shape-only run:
    #: {name: {tag: bytes}, name + "_formats": {format: bytes}} for the
    #: programs of the scheme ("train", "inner", "sync", "gossip")
    wire: dict[str, dict[str, float]] = field(default_factory=dict)

    @property
    def stacked(self) -> bool:
        return stacked_params(self.comm)

    # ---- state ----------------------------------------------------------------

    def _place(self, params: Any, stack: bool) -> Any:
        """Parameters on the device: ``stack`` repeats one tree into W rows;
        a shared tree requires grad (its leaves are differentiated directly)."""
        def place(p):
            p = p.detach().to(self.device)
            if stack:
                return torch.stack([p] * self.n_workers)
            return p if self.stacked else p.requires_grad_(True)

        return tree_map(place, params)

    def init_state(self, params: Any) -> dict[str, Any]:
        """The step state from one parameter tree (every worker starts from
        it)."""
        params = self._place(params, stack=self.stacked)
        return {
            "params": params,
            "opt": self.opt.init(params),
            "comm": aggregate.init_comm_state(self.comm, self.bucket_plan,
                                              self.n_workers, self.device),
            "step": 0,
        }

    def _meta_state(self) -> dict[str, Any]:
        """A state of the right structure, shapes and dtypes that holds no
        memory."""
        meta = dataclasses.replace(self, device=torch.device("meta"))
        return meta.init_state(tree_map(
            lambda d: torch.empty(d.shape, dtype=self.cfg.pdtype, device="meta"),
            T.param_defs(self.cfg)))

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
        holds it.  Views where it can."""
        W, defs = self.n_workers, T.param_defs(self.cfg)
        n_leaves = len(leaves(defs))

        def opt_ref(x):
            if isinstance(x, dict):
                return {k: opt_ref(v) for k, v in x.items()}
            if isinstance(x, list) and len(x) == n_leaves:
                return unflatten_like(defs, [t.reshape(-1) if self.opt.n_shards else t
                                             for t in x])
            return x

        comm = dict(state["comm"])
        for k in _COMM_STACKS:
            if k in comm:
                comm[k] = [torch.zeros(W * b.size, dtype=f32, device=self.device)
                           if e is None else e.reshape(-1)
                           for e, b in zip(comm[k], self.bucket_plan.buckets)]
        if "psgd_q" in comm:
            comm["psgd_q"] = [q.repeat(W) for q in comm["psgd_q"]]
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
            for k in _COMM_STACKS:
                if k in comm:
                    comm[k] = [None if t is None else e.reshape(t.shape)
                               for e, t in zip(comm[k], tmpl["comm"][k])]
            if "psgd_q" in comm:
                comm["psgd_q"] = [q[:q.numel() // self.n_workers] for q in comm["psgd_q"]]
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
        if not grad:
            return tree_map(lambda p: p[w], params)
        return tree_map(lambda p: p[w].detach().requires_grad_(True), params)

    def _grads(self, params: Any, part: dict[str, torch.Tensor], microbatch: int
               ) -> tuple[list[torch.Tensor], dict[str, torch.Tensor]]:
        """One worker's gradients (leaf order) and its loss and metrics."""
        pleaves = leaves(params)
        if microbatch == 1:
            loss, m = T.forward_loss(self.cfg, params, part)
            grads = list(torch.autograd.grad(loss, pleaves))
            return grads, {"loss": loss.detach(), **{k: v.detach() for k, v in m.items()}}
        rows = part["tokens"].shape[0]
        if rows % microbatch:
            raise ValueError(f"local batch {rows} does not split into {microbatch} microbatches")
        mb = rows // microbatch
        acc = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in pleaves]
        ms: dict[str, list[torch.Tensor]] = {"loss": [], "ce": [], "aux": []}
        for j in range(microbatch):
            loss, m = T.forward_loss(self.cfg, params, {k: v[j * mb:(j + 1) * mb]
                                                        for k, v in part.items()})
            for a, g in zip(acc, torch.autograd.grad(loss, pleaves)):
                a.add_(g.to(f32))
            for k, v in (("loss", loss), *m.items()):
                ms[k].append(v.detach())
        grads = [(a / microbatch).to(p.dtype) for a, p in zip(acc, pleaves)]
        return grads, {k: torch.mean(torch.stack(v)) for k, v in ms.items()}

    def _update(self, opt_state: Any, params: Any, grads_of: Callable[[int], list],
                lr: float) -> Any:
        """The optimizer on the shared tree (``grads_of(0)``), or on each
        worker's row in place (``grads_of(w)``, called in worker order); a
        0-dim state leaf (adamw's ``t``) advances once, as each row's update
        returns the same value."""
        pleaves = leaves(params)
        if not self.stacked:
            return self.opt.update(grads_of(0), opt_state, pleaves, lr)[1]
        new = opt_state
        for w in range(self.n_workers):
            rows = tree_map(lambda x: x[w] if isinstance(x, torch.Tensor) and x.ndim else x,
                            opt_state)
            new = self.opt.update(grads_of(w), rows, [p[w] for p in pleaves], lr)[1]
        return unflatten_like(opt_state, [o if o.ndim else n for o, n in
                                          zip(leaves(opt_state), leaves(new))])

    @staticmethod
    def _metrics(ms: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
        return {k: comms.pmean(torch.stack([m[k] for m in ms])) for k in ("loss", "ce", "aux")}

    # ---- the programs -------------------------------------------------------------

    def train_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                   lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        params, plan = state["params"], self.bucket_plan
        rnd = aggregate.AggregationRound(self.comm, plan, state["comm"], self.n_workers,
                                         self.noise, self.device, step=state["step"])
        ms = []
        for w, part in enumerate(self._split(batch)):
            grads, m = self._grads(self._worker_params(params, w), part, self.microbatch)
            rnd.add(w, (aggregate.gather_bucket(b, grads) for b in plan.buckets))
            del grads
            ms.append(m)
        agg, cstate = rnd.finish()
        like = [p[0] for p in leaves(params)] if self.stacked else leaves(params)
        grads = global_clip(aggregate._scatter_buckets(plan, agg, like), self.clip_norm)
        del agg
        opt_state = self._update(state["opt"], params, lambda w: grads, lr)
        out = self._metrics(ms)
        if rnd.nnz is not None:  # the masked sparsifiers' kept share (no collective booked)
            out["kept"] = rnd.nnz / rnd.nnz_of
        return ({"params": params, "opt": opt_state, "comm": cstate,
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
        sync.average_params(leaves(state["params"]), impl=self.comm.collective)
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
        # bucket by bucket: one (W, n) f32 stack at a time (the largest is 2.5 GB)
        with comms.tag("gossip_mix"), torch.no_grad():
            for i, b in enumerate(self.bucket_plan.buckets):
                parts_i = [pl[j].reshape(W, -1).to(f32) for j, _ in b.segments]
                x = parts_i[0] if len(parts_i) == 1 else torch.cat(parts_i, 1)
                del parts_i
                if choco:
                    st = gossip.ChocoState([cstate["choco_xhat"][i]], [cstate["choco_nbr"][i]])
                    (x,), _ = gossip.choco_mix(
                        comm, comp, lambda _, n, i=i: self.noise(step, None, i, n), [x], st,
                        comm.gossip_mix_weight, comp_knobs=(knobs[i],))
                else:
                    (x,) = gossip.dpsgd_mix([x], comm.gossip_mix_weight)
                off = 0
                for j, n in b.segments:
                    pl[j].copy_(x[:, off:off + n].reshape(pl[j].shape))
                    off += n
                del x
        cstate["step"] += 1
        return ({"params": params, "opt": opt_state, "comm": cstate, "step": step + 1},
                self._metrics(ms))

    def eval_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """The worker mean of each worker's forward loss on its rows."""
        with torch.no_grad():
            losses = [T.forward_loss(self.cfg, self._worker_params(state["params"], w, False),
                                     part)[0] for w, part in enumerate(self._split(batch))]
        return comms.pmean(torch.stack(losses))


def _book_wire(bundle: StepBundle) -> dict[str, dict[str, float]]:
    """Run each program of the scheme once on the meta device (no memory,
    no arithmetic) under a comms capture: "train" (not for gossip, which
    never calls it), "inner" and "sync" under local and post-local SGD,
    "gossip" under gossip.  Recomputation is off there: it changes no
    collective."""
    meta = torch.device("meta")
    mb = dataclasses.replace(bundle, cfg=bundle.cfg.with_updates(remat="none"), device=meta,
                             noise=aggregate.seeded_noise(0, meta))
    shape, comm = bundle.shape, bundle.comm
    batch = {k: torch.zeros((shape.global_batch, shape.seq_len), dtype=torch.int32,
                            device=meta) for k in ("tokens", "labels")}
    programs = {}
    if comm.aggregator == "gossip":
        programs["gossip"] = lambda st: mb.gossip_step(st, batch, 0.0)
    else:
        programs["train"] = lambda st: mb.train_step(st, batch, 0.0)
        if comm.sync in ("local", "post_local"):
            programs["inner"] = lambda st: mb.inner_step(st, batch, 0.0)
            programs["sync"] = mb.sync_step
    wire = {}
    for name, run in programs.items():
        state = mb._meta_state()
        with comms.capture() as log:
            run(state)
        wire[name], wire[name + "_formats"] = log.by_tag(), log.by_wire_format()
    return wire


def build_bundle(cfg: ModelConfig, comm: CommConfig, opt: Optimizer, shape: InputShape, *,
                 n_workers: int = 1, seed: int = 0, device: str | torch.device = "cuda",
                 noise: aggregate.Noise | None = None, clip_norm: float = 0.0,
                 microbatch: int = 1) -> StepBundle:
    """Build the steps of one cell.  ``noise(step, worker, bucket, n)``
    overrides the compressors' uniform draws (default: a generator seeded
    from (seed, step, worker, bucket) on ``device``; worker None for
    CHOCO-SGD's draw, which every worker shares); ``clip_norm > 0`` clips
    the aggregated gradient (each worker's own on an inner step) to that
    global norm before the update, as the reference's step does;
    ``microbatch`` splits each worker's rows into that many accumulated
    chunks."""
    validate(comm)
    if opt.n_shards and opt.n_shards != n_workers:
        raise ValueError(f"{opt.name} shards its state over {opt.n_shards} workers, "
                         f"the bundle has {n_workers}")
    if opt.n_shards and stacked_params(comm):
        raise NotImplementedError(
            f"{opt.name} under sync={comm.sync!r}, aggregator={comm.aggregator!r} is not "
            "ported: the reference regathers each worker's own slices into every "
            "worker's parameters there")
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    device = torch.device(device)
    bundle = StepBundle(
        cfg=cfg, comm=comm, shape=shape, n_workers=n_workers, device=device,
        bucket_plan=aggregate.make_bucket_plan(comm, T.param_defs(cfg)), opt=opt,
        noise=noise if noise is not None else aggregate.seeded_noise(seed, device),
        clip_norm=clip_norm, microbatch=microbatch,
    )
    bundle.wire = _book_wire(bundle)
    return bundle


@dataclass
class ServeBundle:
    cfg: ModelConfig
    shape: InputShape  # global_batch is the batch every call must carry
    device: torch.device
    #: (params, {"tokens": (B, S)}) -> (last hidden (B, d), cache)
    prefill_step: Callable
    #: (params, cache, tokens (B, 1)) -> (next tokens (B, 1) int32, new cache)
    serve_step: Callable


def build_serve(cfg: ModelConfig, shape: InputShape,
                device: str | torch.device = "cuda") -> ServeBundle:
    """Prefill and decode steps for ``cfg`` (RWKV6 only: the dense family's
    serving is a later slice and raises ``NotImplementedError``).  Both steps
    run under ``torch.inference_mode()``, take their tokens as numpy arrays
    or tensors (moved to ``device``), and run the recurrence through kernel
    ``wkv6`` (its plain version on the CPU)."""
    T.check_serving(cfg)
    device = torch.device(device)

    def _tokens(tok) -> torch.Tensor:
        tok = torch.as_tensor(tok).to(device)
        if tok.shape[0] != shape.global_batch:
            raise ValueError(f"batch {tok.shape[0]} != the bundle's {shape.global_batch}")
        return tok

    def prefill_step(params, batch):
        with torch.inference_mode():
            return T.prefill(cfg, params, {"tokens": _tokens(batch["tokens"])},
                             use_kernel=True)

    def serve_step(params, cache, tok):
        with torch.inference_mode():
            return T.decode_step(cfg, params, cache, _tokens(tok), use_kernel=True)

    return ServeBundle(cfg=cfg, shape=shape, device=device, prefill_step=prefill_step,
                       serve_step=serve_step)
