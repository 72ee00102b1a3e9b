"""Optimizers on parameter trees (counterpart of ``repro.optim.optimizers``:
``sgd``, ``momentum_sgd``, ``adamw``, ``zero1`` and ``global_clip``).

State is f32 whatever the parameter dtype.  ``update`` works in place: the
moment buffers and the parameters are overwritten, which keeps one copy of
each at full width; the arithmetic is the reference's, step by step in f32
(no fused multiply-add: ``add_`` with ``alpha`` would contract).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core import comms
from repro_torch.models.sharding import shard_local
from repro_torch.utils.tree import leaves

f32 = torch.float32


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(v), dtype=f32, device=like.device)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    #: (grads, state, params, lr) -> (params, state); grads and params are
    #: leaf lists in tree order
    update: Callable[[list, Any, list, float], tuple[list, Any]]
    name: str = "opt"
    #: workers the state is sharded over (``zero1``); 0: not sharded
    n_shards: int = 0
    #: ``zero1``'s update of diverging (R, *shape) parameter rows:
    #: (grads_of, state, params, lr, row_of) -> state, ``grads_of(r)`` row
    #: r's gradient leaves and ``row_of(w)`` the row worker w holds
    update_rows: Callable | None = None
    #: ``zero1`` under the model axis: (shard dims, M) -> the optimizer that
    #: slices each shard-local leaf over the workers
    for_model: Callable | None = None


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.copy_(p.to(f32) - lr * g.to(f32))
        return params, state

    return Optimizer(init, update, "sgd")


def momentum_sgd(m: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"v": [torch.zeros(p.shape, dtype=f32, device=p.device) for p in leaves(params)]}

    def update(grads, state, params, lr):
        with torch.no_grad():
            for p, g, v in zip(params, grads, state["v"]):
                v.mul_(m).add_(g.to(f32))
                step = g.to(f32) + m * v if nesterov else v
                p.copy_(p.to(f32) - lr * step)
        return params, state

    return Optimizer(init, update, f"momentum{m}")


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, wd: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay; f32 moments and an int32 step count
    ``t``, the bias corrections ``1 - b**t`` taken in f32."""

    def init(params):
        ps = leaves(params)
        dev = ps[0].device if ps else "cpu"
        return {"m": [torch.zeros(p.shape, dtype=f32, device=p.device) for p in ps],
                "v": [torch.zeros(p.shape, dtype=f32, device=p.device) for p in ps],
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        with torch.no_grad():
            t = state["t"] + 1
            tf = t.to(f32)
            bc1 = 1 - torch.pow(_scalar(b1, tf), tf)
            bc2 = 1 - torch.pow(_scalar(b2, tf), tf)
            for p, g, m, v in zip(params, grads, state["m"], state["v"]):
                g = g.to(f32)
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(torch.square(g) * (1 - b2))
                step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if wd:
                    step = step + wd * p.to(f32)
                p.copy_(p.to(f32) - lr * step)
        return params, {"m": state["m"], "v": state["v"], "t": t}

    return Optimizer(init, update, "adamw")


def zero1(opt: Optimizer, n_workers: int, shard_dims: tuple | None = None,
          msize: int = 1) -> Optimizer:
    """ZeRO-1: optimizer state sharded over the W data-parallel workers.

    Every leaf is flattened and zero-padded to a multiple of W; worker w
    keeps row w of the (W, n / W) view of each state leaf and updates row w
    of the parameters with ``opt``'s arithmetic, and the new parameters are
    regathered with one all-gather per leaf, booked under tag
    ``zero1_gather`` (one worker's row at the parameters' dtype).  On one
    card the W rows are one stacked tensor, so the shards update together.

    Under the schemes whose workers' parameters diverge (one (R, *shape) row
    per worker, or per pod under pod-local SGD), ``update_rows`` runs the
    reference's arithmetic there: worker w updates slice w of its *own* row
    with slice w of that row's gradient, and the all-gather over every
    worker hands each worker the same concatenation of the W slices, which
    every row then holds.  So the rows are equal after every ZeRO-1 step, as
    in the reference.

    Under the model axis (``msize`` M > 1, ``shard_dims`` each leaf's
    sharded dimension) each of the M shards slices its own local leaf
    (:func:`shard_local`, flattened and padded) over the W workers, as the
    reference's devices do: a state leaf is (W, M, k), in the reference's
    (worker, shard) device order, and the all-gather books one shard's
    slice.  A replicated leaf's M slices hold the same values; shard 0's
    are written back.
    """

    def _pad_rows(flat):
        pad = (-flat.numel()) % n_workers
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.reshape(n_workers, -1)

    def _rows(leaf, dim=None):
        if msize == 1:
            return _pad_rows(leaf.reshape(-1))
        return torch.stack([_pad_rows(shard_local(leaf, dim, msize, m).reshape(-1))
                            for m in range(msize)], 1)

    def _dims(n):  # each leaf's sharded dimension (none at model-axis size 1)
        return shard_dims or [None] * n

    def init(params):
        ps = leaves(params)
        return {"inner": opt.init([_rows(p, d) for p, d in zip(ps, _dims(len(ps)))])}

    def update(grads, state, params, lr):
        ds = _dims(len(params))
        with torch.no_grad():
            p_sl = [_rows(p, d) for p, d in zip(params, ds)]
            _, inner = opt.update([_rows(g, d) for g, d in zip(grads, ds)], state["inner"],
                                  p_sl, lr)
            with comms.tag("zero1_gather"):
                for p, new, d in zip(params, p_sl, ds):
                    if msize == 1:
                        comms.all_gather(new)
                        if new.data_ptr() != p.data_ptr():  # padded: a copy of p
                            p.copy_(new.reshape(-1)[:p.numel()].reshape(p.shape))
                        continue
                    comms.all_gather(new[:, 0])
                    for m in range(msize if d is not None else 1):
                        blk = shard_local(p, d, msize, m)
                        blk.copy_(new[:, m].reshape(-1)[:blk.numel()].reshape(blk.shape))
        return params, {"inner": inner}

    def _slice_into(dst, leaf, w):
        """Slice w of ``leaf``'s zero-padded (W, k) view into ``dst``."""
        part = leaf.reshape(-1)[w * dst.numel():(w + 1) * dst.numel()]
        dst[:part.numel()] = part
        dst[part.numel():] = 0

    def update_rows(grads_of, state, params, lr, row_of):
        p_sl = [torch.empty((n_workers, -(-p[0].numel() // n_workers)), dtype=p.dtype,
                            device=p.device) for p in params]
        g_sl, cached = [], {}
        for w in range(n_workers):
            r = row_of(w)
            if r not in cached:
                cached = {r: grads_of(r)}  # rows come in order: keep one
            with torch.no_grad():
                for j, (p, g) in enumerate(zip(params, cached[r])):
                    if w == 0:
                        g_sl.append(torch.empty_like(p_sl[j], dtype=g.dtype))
                    _slice_into(p_sl[j][w], p[r], w)
                    _slice_into(g_sl[j][w], g, w)
        del cached
        with torch.no_grad():
            _, inner = opt.update(g_sl, state["inner"], p_sl, lr)
            with comms.tag("zero1_gather"):
                for p, new in zip(params, p_sl):
                    comms.all_gather(new)
                    p.copy_(new.reshape(-1)[:p[0].numel()].reshape(p.shape[1:]))
        return {"inner": inner}

    return Optimizer(init, update, f"zero1_{opt.name}", n_workers, update_rows,
                     lambda sdims, m: zero1(opt, n_workers, tuple(sdims), m))


def global_clip(grads: list, max_norm: float) -> list:
    """Global-norm gradient clipping: every leaf times
    min(1, max_norm / ||grads||), the norm over all leaves in f32 (leaf
    sums added in leaf order); 0 leaves the gradients alone."""
    if not max_norm:
        return grads
    g2 = sum(torch.sum(torch.square(g.to(f32))) for g in grads)
    scale = torch.clamp_max(_scalar(max_norm, g2) / torch.clamp_min(torch.sqrt(g2), 1e-30), 1.0)
    return [(g.to(f32) * scale).to(g.dtype) for g in grads]
