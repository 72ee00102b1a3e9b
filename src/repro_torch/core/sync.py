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

Over ranks of the data axis (``comms.ranks``) a rank holds only its own
rows of the stack, and the average moves the other ranks' contributions
for real: the ``xla`` sum gathers the rows and adds them in worker order,
the ``ring`` and ``rhd`` schedules send their hops between the ranks.

Under churn the average runs over the live rows only (``alive``), or over
the donors (``donor``: ``pull_avg`` excludes a stale rejoiner), and may
carry a wire copy of the parameters (``payload``: the integrity axis's
possibly corrupted copy, selected out where it is no donor's).
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

    Churn (the reference's masked averaging): ``alive`` is the (R,) 0/1
    participation vector of the round.  The average is taken over the rows
    whose ``donor`` bit is set (``alive`` when no ``donor`` is given), their
    count one booked scalar psum; a live row adopts it, a dead row keeps its
    parameters, and with no donor at all every row keeps its own.
    ``payload`` (integrity) maps a leaf's index to its f32 wire copy, (R,
    ...) like the leaf (a function, so one copy lives at a time): the sum
    runs over the copies, a non-donor's copy selected out (never multiplied by
    0: a NaN times 0 is NaN); adoption and the fallback use the clean
    ``params``.  ``donor`` or ``payload`` without ``alive`` raises
    ``ValueError``.

    Under a rank group each leaf is the rank's own rows: (W/R, *shape), or
    pod-local SGD's one row at one pod (``copies`` W), of which the rank
    sums only its own W/R copies; every row the rank holds adopts the mean
    over all W.  So are ``alive``, ``donor`` and ``payload``: the rank's
    own rows, the donor count the booked psum of a (W, 1) stack whose own
    workers' rows the rank wrote."""
    if alive is None:
        if donor is not None or payload is not None:
            raise ValueError("average_params: donor and payload need alive")
        with comms.tag("local_sgd_sync"), torch.no_grad():
            for p in params:
                x = p.reshape(p.shape[0], -1).to(f32)
                total, W = _allreduce(x, impl, copies)
                avg = total / W
                p.copy_(avg.reshape(p.shape[1:]).to(p.dtype))
        return params
    w = alive if donor is None else donor
    with comms.tag("local_sgd_sync"), torch.no_grad():
        n_don = comms.psum(comms.worker_stack(_own_copies(w, copies)[:, None]))[0]
        n_eff = torch.clamp_min(n_don, 1.0)
        adopt = (alive > 0) & (n_don > 0)
        for i, p in enumerate(params):
            x = p.reshape(p.shape[0], -1).to(f32)
            if payload is not None:
                x = torch.where(w[:, None] > 0, payload(i).reshape(x.shape).to(f32), 0.0)
            else:
                x = x * w[:, None]
            avg = (_allreduce(x, impl, copies)[0] / n_eff).reshape(p.shape[1:]).to(p.dtype)
            del x
            p.copy_(torch.where(adopt.reshape((-1,) + (1,) * (p.dim() - 1)), avg, p))
    return params


def _own_copies(x: torch.Tensor, copies: int) -> torch.Tensor:
    """Each worker this process holds gets its row's entry of ``x`` (the
    rows this process holds, each standing for ``copies`` workers)."""
    if copies == 1:
        return x
    own = comms.own_workers(x.shape[0] * copies)
    return x[torch.arange(own.start, own.stop, device=x.device) // copies]


def _allreduce(x: torch.Tensor, impl: str, copies: int) -> tuple[torch.Tensor, int]:
    """The f32 sum over the W workers of an (R, n) stack whose rows each
    stand for ``copies`` workers, by schedule ``impl``, and W; under a rank
    group ``x`` is the rank's own rows (or all R rows when ``copies`` > 1,
    of which the rank sums its own workers' copies)."""
    x = _own_copies(x, copies)  # each worker this process holds gets its row's copy
    (k, n), (group, W, lo) = x.shape, comms.layout(x)
    if impl == "xla":
        if group is None:
            return comms.psum(x), W
        full = x.new_empty((W, n))  # the other ranks' rows gathered in
        full[lo:lo + k] = x
        del x
        return comms.psum(full), W
    stack = x.new_zeros((k, collectives.padded_len(n, W)))
    stack[:, :n] = x
    del x
    return collectives.allreduce(stack, n, impl), W
