"""Auxiliary technologies on one worker's flat bucket vector (counterpart of
``repro.core.feedback``: ``local_clip``, ``warmup_ratio``,
``pre_compress``, ``post_compress``): momentum correction, local gradient
clipping and error feedback with decay, in DGC's order, and DGC's
sparsity warm-up ramp.

The port keeps the W stacked workers' state as (W, size) stacks per bucket
(``state["u"][i]``, ``state["ef"][i]``), so the functions take the worker
index ``w`` and update that worker's row in place.  Churn's freeze masks
are not ported.  ``state["ef"][i]`` is None for a
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
                 n_workers: int) -> torch.Tensor:
    """Momentum correction + EF accumulation + local clipping for worker
    ``w``'s bucket ``idx``: returns the vector handed to the compressor.
    Worker w's momentum row is updated in place (``u = m*u + g``)."""
    if comm.momentum_correction:
        g = state["u"][idx][w].mul_(comm.momentum_correction).add_(g)
    if comm.local_clip:
        g = local_clip(g, comm.local_clip, n_workers)
    if comm.error_feedback and state["ef"][idx] is not None:
        g = state["ef"][idx][w] * _scalar(comm.ef_decay, g) + g
    return g


def post_compress(comm: CommConfig, a: torch.Tensor, a_hat: torch.Tensor,
                  state: dict[str, Any], idx: int, w: int) -> None:
    """Error accumulation ``e = a - C(a)``, written into worker ``w``'s row."""
    if comm.error_feedback:
        torch.sub(a, a_hat, out=state["ef"][idx][w])
