"""Step builder: model, gradient exchange and optimizer for W data-parallel
workers stacked on one device (counterpart of ``repro.train.steps``:
``build_bundle`` and the BSP ``train_step``, sequential overlap).

A step splits the global batch into W contiguous row blocks (the
reference's batch sharding over ``data``).  For each worker in turn it runs
forward and backward on the shared parameters and hands the gradient,
bucket by bucket, to the send side of an :class:`AggregationRound`
(momentum, clipping and error feedback, then compression into that
worker's row of the wire stack); only the wire payload and the worker's
state rows outlive the worker.  The receive side then reduces every
bucket, ``clip_norm`` (if set) clips the aggregate to that global norm, and
the optimizer updates the parameters in place.  Loss, ``ce``
and ``aux`` are worker means; ``kept`` is the share of elements that the
masked sparsifiers (the threshold family, ``wangni``, ``variance_sparse``)
kept this step, over all workers and their buckets.

The wire bytes of one step are booked at build time by running the step
once on the ``meta`` device, which computes shapes only.

``build_serve`` is the serving counterpart (``ServeBundle``: prefill a batch
of prompts, then one greedy token per call), for the RWKV6 family; one card
is one device, so there is no mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import aggregate, comms
from repro_torch.core.types import CommConfig, validate
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer, global_clip
from repro_torch.utils.tree import leaves, tree_map

f32 = torch.float32


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
    #: global-norm clip of the aggregated gradient (0: off)
    clip_norm: float = 0.0
    #: per-step wire bytes by tag, booked from one shape-only step:
    #: {"train": {tag: bytes}, "train_formats": {format: bytes}}
    wire: dict[str, dict[str, float]] = field(default_factory=dict)

    def init_state(self, params: Any) -> dict[str, Any]:
        params = tree_map(lambda p: p.detach().to(self.device).requires_grad_(True), params)
        return {
            "params": params,
            "opt": self.opt.init(params),
            "comm": aggregate.init_comm_state(self.comm, self.bucket_plan,
                                              self.n_workers, self.device),
            "step": 0,
        }

    def train_step(self, state: dict[str, Any], batch: dict[str, torch.Tensor],
                   lr: float) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        return _train_step(self.cfg, self.comm, self.bucket_plan, self.opt,
                           self.n_workers, self.noise, state, batch, lr, self.clip_norm)


def _train_step(cfg, comm, plan, opt, n_workers, noise, state, batch, lr, clip_norm):
    params = state["params"]
    pleaves = leaves(params)
    B = batch["tokens"].shape[0]
    if B % n_workers:
        raise ValueError(f"global batch {B} does not split over {n_workers} workers")
    bl = B // n_workers
    device = pleaves[0].device
    rnd = aggregate.AggregationRound(comm, plan, state["comm"], n_workers, noise, device)
    metrics: dict[str, list[torch.Tensor]] = {"loss": [], "ce": [], "aux": []}
    for w in range(n_workers):
        part = {k: v[w * bl:(w + 1) * bl] for k, v in batch.items()}
        loss, m = T.forward_loss(cfg, params, part)
        grads = torch.autograd.grad(loss, pleaves)
        rnd.add(w, (aggregate.gather_bucket(b, grads) for b in plan.buckets))
        del grads
        for k, v in (("loss", loss), *m.items()):
            metrics[k].append(v.detach())
    agg, cstate = rnd.finish()
    grads = global_clip(aggregate._scatter_buckets(plan, agg, pleaves), clip_norm)
    del agg
    _, opt_state = opt.update(grads, state["opt"], pleaves, lr)
    out = {k: comms.pmean(torch.stack(v)) for k, v in metrics.items()}
    if rnd.nnz is not None:  # the masked sparsifiers' kept share (no collective booked)
        out["kept"] = rnd.nnz / rnd.nnz_of
    return ({"params": params, "opt": opt_state, "comm": cstate,
             "step": state["step"] + 1}, out)


def _book_wire(cfg, comm, plan, opt, shape, n_workers, clip_norm
               ) -> dict[str, dict[str, float]]:
    """Run one step on the meta device (no memory, no arithmetic) under a
    comms capture.  Recomputation is off there: it changes no collective."""
    meta = torch.device("meta")
    mcfg = cfg.with_updates(remat="none")
    params = tree_map(lambda d: torch.empty(d.shape, dtype=cfg.pdtype, device=meta)
                      .requires_grad_(True), T.param_defs(cfg))
    state = {"params": params, "opt": opt.init(params),
             "comm": aggregate.init_comm_state(comm, plan, n_workers, meta), "step": 0}
    batch = {k: torch.zeros((shape.global_batch, shape.seq_len), dtype=torch.int32,
                            device=meta) for k in ("tokens", "labels")}
    with comms.capture() as log:
        _train_step(mcfg, comm, plan, opt, n_workers, aggregate.seeded_noise(0, meta),
                    state, batch, 0.0, clip_norm)
    return {"train": log.by_tag(), "train_formats": log.by_wire_format()}


def build_bundle(cfg: ModelConfig, comm: CommConfig, opt: Optimizer, shape: InputShape, *,
                 n_workers: int = 1, seed: int = 0, device: str | torch.device = "cuda",
                 noise: aggregate.Noise | None = None, clip_norm: float = 0.0) -> StepBundle:
    """Build the BSP step for one cell.  ``noise(step, worker, bucket, n)``
    overrides the compressors' uniform draws (default: a generator seeded
    from (seed, step, worker, bucket) on ``device``); ``clip_norm > 0``
    clips the aggregated gradient to that global norm before the update,
    as the reference's step does."""
    validate(comm)
    if opt.n_shards and opt.n_shards != n_workers:
        raise ValueError(f"{opt.name} shards its state over {opt.n_shards} workers, "
                         f"the bundle has {n_workers}")
    device = torch.device(device)
    plan = aggregate.make_bucket_plan(comm, T.param_defs(cfg))
    return StepBundle(
        cfg=cfg, comm=comm, shape=shape, n_workers=n_workers, device=device,
        bucket_plan=plan, opt=opt,
        noise=noise if noise is not None else aggregate.seeded_noise(seed, device),
        clip_norm=clip_norm,
        wire=_book_wire(cfg, comm, plan, opt, shape, n_workers, clip_norm),
    )


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
