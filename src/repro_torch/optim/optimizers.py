"""Optimizers on parameter trees (counterpart of ``repro.optim.optimizers``:
``sgd`` and ``momentum_sgd``).

State is f32 whatever the parameter dtype.  ``update`` works in place: the
momentum buffer and the parameters are overwritten, which keeps one copy of
each at full width; the arithmetic is the reference's, step by step in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.utils.tree import leaves

f32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    #: (grads, state, params, lr) -> (params, state); grads and params are
    #: leaf lists in tree order
    update: Callable[[list, Any, list, float], tuple[list, Any]]
    name: str = "opt"


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
