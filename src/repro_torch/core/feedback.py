"""Auxiliary technologies on one worker's flat bucket vector (counterpart of
``repro.core.feedback``: ``local_clip``, ``warmup_ratio``,
``pre_compress``, ``post_compress``): momentum correction, local gradient
clipping and error feedback with decay, in DGC's order, and DGC's
sparsity warm-up ramp.

The port keeps the W stacked workers' state as (W, size) stacks per bucket
(``state["u"][i]``, ``state["ef"][i]``), so the functions take the
worker's row ``w`` and update it in place.  Over ranks a process holds its
own W/R workers' rows only, and ``w`` is the worker's index less the
rank's first (:class:`repro_torch.core.aggregate.AggregationRound`).  Under churn a masked
worker (``alive`` 0) neither sends nor accumulates: its momentum row and
EF residual freeze.  ``state["ef"][i]`` is None for a
bucket without a compressor: its residual would stay zero for ever (the
reference never updates it), and adding a zero changes nothing.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.types import CommConfig

f32 = torch.float32


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device, filled there (no host copy,
    and no divide-by-host-scalar rewritten as a reciprocal multiply)."""
    return torch.full((), float(v), dtype=f32, device=like.device)


def local_clip(g: torch.Tensor, thr: float, n_workers: int) -> torch.Tensor:
    """Local Gradient Clipping: each worker clips at thr / sqrt(N) so the
    aggregated gradient keeps the global threshold."""
    if not thr:
        return g
    norm = torch.clamp_min(torch.linalg.vector_norm(g), 1e-30)
    return g * torch.clamp_max(_scalar(thr * n_workers ** -0.5, g) / norm, 1.0)


def warmup_ratio(base_ratio: float, step, warmup_steps: int) -> torch.Tensor:
    """DGC warm-up: the kept ratio ramps exponentially from 25% to
    ``base_ratio`` over ``warmup_steps``; a 0-dim f32 tensor on the device
    of ``step`` (an int or a tensor)."""
    step = torch.as_tensor(step)
    if not warmup_steps:
        return _scalar(base_ratio, step)
    t = torch.clamp_max(step.to(f32) / _scalar(warmup_steps, step), 1.0)
    return torch.exp(torch.log(_scalar(0.25, step)) * (1 - t)
                     + torch.log(_scalar(base_ratio, step)) * t)


def pre_compress(comm: CommConfig, g: torch.Tensor, state: dict[str, Any], idx: int, w: int,
                 n_workers: int, alive: torch.Tensor | None = None) -> torch.Tensor:
    """Momentum correction + EF accumulation + local clipping for worker
    ``w``'s bucket ``idx``: returns the vector handed to the compressor.
    Worker w's momentum row is updated in place (``u = m*u + g``); with
    ``alive`` (its 0-dim 0/1 bit) only where it is 1, though the vector
    returned is built from the new ``u`` either way."""
    if comm.momentum_correction:
        u = state["u"][idx][w]
        if alive is None:
            g = u.mul_(comm.momentum_correction).add_(g)
        else:
            g = u * _scalar(comm.momentum_correction, u) + g
            torch.where(alive > 0, g, u, out=u)
    if comm.local_clip:
        g = local_clip(g, comm.local_clip, n_workers)
    if comm.error_feedback and state["ef"][idx] is not None:
        g = state["ef"][idx][w] * _scalar(comm.ef_decay, g) + g
    return g


def post_compress(comm: CommConfig, a: torch.Tensor, a_hat: torch.Tensor,
                  state: dict[str, Any], idx: int, w: int,
                  alive: torch.Tensor | None = None) -> None:
    """Error accumulation ``e = a - C(a)``, written into worker ``w``'s row
    (with ``alive``, only where it is 1: a masked or quarantined round
    leaves the residual frozen)."""
    if comm.error_feedback:
        e = state["ef"][idx][w]
        if alive is None:
            torch.sub(a, a_hat, out=e)
        else:
            torch.where(alive > 0, a - a_hat, e, out=e)
