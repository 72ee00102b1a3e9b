"""Gossip (decentralized) training (counterpart of ``repro.core.gossip``):
neighbour mixing on the ring of workers, D-PSGD and CHOCO-SGD.

Each worker's parameters are row w of a (W, n) f32 bucket stack, so a ring
exchange is a roll of the stack along the worker axis
(:func:`repro_torch.core.comms.ppermute`).  The ring mixing matrix is
I(1 - 2w) + w(L + R), doubly stochastic; the reference's runtime runs this
ring whatever ``gossip_graph`` says, and so does the port.  Churn (the
``alive``/``rejoined`` arguments, ``masked_mixing_matrix``) is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core import comms
from repro_torch.core.compression.base import (
    compress_p,
    decompress_p,
    needs_noise,
    noise_len,
)
from repro_torch.core.types import CommConfig

f32 = torch.float32


def ring_mixing_matrix(n: int, w: float = 1.0 / 3.0) -> np.ndarray:
    """Symmetric doubly-stochastic ring weights (at n = 2 both neighbours
    coincide and the off-diagonal weight doubles)."""
    W = np.eye(n) * (1 - 2 * w)
    for j in range(n):
        W[j, (j + 1) % n] += w
        W[j, (j - 1) % n] += w
    return W


def ring_mixing_matrix_traced(n: int, w) -> torch.Tensor:
    """:func:`ring_mixing_matrix` with the weight as a tensor, in f32: ``w``
    of shape (C,) (one weight per cell of a sweep) gives a (C, n, n)
    stack, a 0-dim ``w`` one (n, n) matrix.  The convergence engine's gossip
    mixing."""
    w = torch.as_tensor(w, dtype=f32)
    eye = torch.eye(n, dtype=f32, device=w.device)
    ring = torch.roll(eye, 1, 0) + torch.roll(eye, -1, 0)
    w = w[..., None, None]
    return eye * (1 - 2 * w) + w * ring


def exp_mixing_matrix(n: int) -> np.ndarray:
    """One-peer exponential graph (powers of two), averaged over rounds."""
    rounds = max(1, int(math.log2(n)))
    W = np.zeros((n, n))
    for s in range(rounds):
        stride = 2**s
        Ws = np.eye(n) * 0.5
        for j in range(n):
            Ws[j, (j + stride) % n] += 0.5
        W += Ws / rounds
    return W


def spectral_gap(W: np.ndarray) -> float:
    ev = np.sort(np.abs(np.linalg.eigvals(W)))[::-1]
    return float(ev[1])


def _neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """Left plus right ring neighbour of every row of the (W, n) stack."""
    total = comms.ppermute(x, 1)
    return total.add_(comms.ppermute(x, -1))


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    # an f32 scalar, as the reference's traced knobs are: 1 - 2w rounds in f32
    return torch.full((), float(v), dtype=f32, device=like.device)


def _no_churn(alive, rejoined) -> None:
    if alive is not None or rejoined is not None:
        raise NotImplementedError("gossip under churn is not ported")


def dpsgd_mix(bufs: list[torch.Tensor], w: float = 1.0 / 3.0, alive=None,
              rejoined=None) -> list[torch.Tensor]:
    """D-PSGD: x_i <- (1 - 2w) x_i + w (x_left + x_right), for each (W, n)
    stack of ``bufs``."""
    _no_churn(alive, rejoined)
    out = []
    for p in bufs:  # in place on temporaries: a bucket stack is up to 2.5 GB
        wt = _scalar(w, p)
        mixed = (1 - 2 * wt) * p
        out.append(mixed.add_(_neighbor_sum(p).mul_(wt)))
    return out


@dataclass
class ChocoState:
    """CHOCO-SGD state of every worker: its x_hat, and the sum of its ring
    neighbours' x_hat, one (W, n) f32 stack per bucket each."""

    x_hat: list[torch.Tensor]
    x_hat_nbr: list[torch.Tensor]


def choco_init(bufs: list[torch.Tensor]) -> ChocoState:
    return ChocoState([torch.zeros_like(p) for p in bufs],
                      [torch.zeros_like(p) for p in bufs])


def choco_mix(comm: CommConfig, compressor, noise: Callable[[int, int], torch.Tensor],
              bufs: list[torch.Tensor], st: ChocoState, w: float = 1.0 / 3.0, *,
              gamma: float | None = None, comp_knobs: tuple[dict, ...] | None = None,
              alive=None, rejoined=None) -> tuple[list[torch.Tensor], ChocoState]:
    """One CHOCO-SGD round: every worker sends q = C(x - x_hat) to both
    ring neighbours; x_hat += q, the neighbour sum += the neighbours' q, and
    x <- x + gamma (w x_hat_nbr - 2w x_hat).

    ``noise(bucket, n)`` gives bucket i's uniform draws, one draw shared by
    every worker (the reference folds no worker index into the CHOCO key).
    Each worker's payload is decoded once and the decoded stack is rolled to
    the neighbours (the same values in the same additions as decoding each
    received payload), while the wire books the two payload ``ppermute``
    rounds of the reference.  The state's stacks are updated in place."""
    _no_churn(alive, rejoined)
    gamma = comm.gossip_step_size if gamma is None else gamma
    new_x = []
    for i, (p, xh, xn) in enumerate(zip(bufs, st.x_hat, st.x_hat_nbr)):
        W, n = p.shape
        kn = comp_knobs[i] if comp_knobs is not None else None
        u = noise(i, noise_len(compressor, n)) if needs_noise(compressor) else None
        q_self = torch.empty_like(p)
        for wk in range(W):
            c = compress_p(compressor, u, p[wk] - xh[wk], kn)
            q_self[wk] = decompress_p(compressor, c, kn)
        for _ in range(2):  # to the right neighbour, then to the left one, key by key
            for v in c.payload.values():
                comms.book_ppermute(v, W)
        q_nbr = torch.roll(q_self, 1, 0).add_(torch.roll(q_self, -1, 0))
        xh.add_(q_self)
        del q_self
        xn.add_(q_nbr)
        del q_nbr
        wt, gt = _scalar(w, p), _scalar(gamma, p)
        step = (wt * xn).sub_(2 * wt * xh)
        new_x.append(step.mul_(gt).add_(p))
    return new_x, st
