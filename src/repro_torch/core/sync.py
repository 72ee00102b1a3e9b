"""Synchronization schemes (counterpart of ``repro.core.sync``): which steps
aggregate gradients and which average parameters, and the parameter
average of local SGD.

BSP aggregates gradients every step.  Local SGD runs H local steps, then
averages the *parameters*; post-local SGD runs BSP up to
``post_local_switch``, then local SGD, and keeps aggregating gradients on
its sync steps.  Under these schemes each worker's parameters are row w of
a (W, *shape) stack, so the average is an all-reduce over the stack.
Pod-local SGD (``pod_local``, which overrides ``sync``) aggregates
gradients inside each pod on every step and averages the parameters across
pods every H steps; its stack holds one row per pod, so that average is an
all-reduce over the pod rows, booked over the ``pod`` axis.
"""

from __future__ import annotations

import torch

from repro_torch.core import collectives, comms
from repro_torch.core.types import CommConfig

f32 = torch.float32


def grads_need_aggregation(comm: CommConfig, step: int) -> bool:
    """Does this step aggregate gradients (the train step) or not (the
    inner step)?"""
    if comm.pod_local:
        return True  # BSP inside each pod every step
    if comm.sync == "bsp":
        return True
    if comm.sync == "post_local":
        return step < comm.post_local_switch or _is_sync_step(step, comm.local_steps)
    if comm.sync == "local":
        return False  # local SGD averages parameters, not gradients
    raise ValueError(comm.sync)


def params_need_sync(comm: CommConfig, step: int) -> bool:
    if comm.pod_local:
        return _is_sync_step(step, comm.local_steps)
    if comm.sync == "local":
        return _is_sync_step(step, comm.local_steps)
    if comm.sync == "post_local":
        return step >= comm.post_local_switch and _is_sync_step(step, comm.local_steps)
    return False


def _is_sync_step(step: int, H: int) -> bool:
    return H > 0 and (step + 1) % H == 0


def average_params(params: list[torch.Tensor], impl: str = "xla", alive=None, donor=None,
                   payload=None, copies: int = 1) -> list[torch.Tensor]:
    """Model averaging for local SGD, in place: every (R, *shape) leaf of
    ``params`` becomes the mean of its rows on every row.  Each leaf is
    summed in f32 by schedule ``impl`` (one booked psum for ``xla``; the
    ring and rhd hops of :mod:`repro_torch.core.collectives`) over n = R *
    ``copies`` workers (each row held by ``copies`` consecutive workers, as
    pod-local SGD's one row stands for all W workers of a single pod),
    divided by n and cast back to the leaf's dtype, booked under tag
    ``local_sgd_sync`` (over the axes of the enclosing ``comms.over``).

    ``alive``, ``donor`` and ``payload`` (churn and integrity) are not
    ported and raise ``NotImplementedError``."""
    if alive is not None or donor is not None or payload is not None:
        raise NotImplementedError("average_params under churn or integrity is not ported")
    with comms.tag("local_sgd_sync"), torch.no_grad():
        for p in params:
            W, n = p.shape[0] * copies, p[0].numel()
            x = p.reshape(p.shape[0], n).to(f32)
            if copies > 1:
                x = x.repeat_interleave(copies, 0)
            if impl == "xla":
                total = comms.psum(x)
            else:
                stack = x.new_zeros((W, collectives.padded_len(n, W)))
                stack[:, :n] = x
                del x
                total = collectives.allreduce(stack, n, impl)
            p.copy_((total / W).reshape(p.shape[1:]).to(p.dtype))
    return params
