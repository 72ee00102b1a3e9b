"""Gossip (decentralized) training (counterpart of ``repro.core.gossip``):
neighbour mixing on the ring of workers, D-PSGD and CHOCO-SGD.

Each worker's parameters are row w of a (W, n) f32 bucket stack, so a ring
exchange is a roll of the stack along the worker axis
(:func:`repro_torch.core.comms.ppermute`).  The ring mixing matrix is
I(1 - 2w) + w(L + R), doubly stochastic; the reference's runtime runs this
ring whatever ``gossip_graph`` says, and so does the port.  Under churn the
ring is masked: :func:`masked_mixing_matrix` folds a dropped peer's weight
into each live row's self weight, ``dpsgd_mix(alive, rejoined)`` mixes with it,
and ``choco_mix`` runs its masked round (``_choco_mix_churn``).
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


def masked_mixing_matrix(W: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Renormalize mixing matrices ``W`` (..., n, n) over the live peer sets
    ``m`` (..., n) (1 alive, 0 dropped; the leading axes broadcast): a dead
    peer's column weight folds into each live row's self weight, so row
    sums are kept exactly and an all-ones mask gives ``W`` back bitwise;
    dead rows become identity rows (their parameters freeze)."""
    n = W.shape[-1]
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    m = m.to(W.dtype)
    off = W * (1.0 - eye)
    dead_w = torch.sum(off * (1.0 - m[..., None, :]), dim=-1)  # weight lost per row
    Wm = off * m[..., None, :] + torch.diag_embed(torch.diagonal(W, dim1=-2, dim2=-1) + dead_w)
    return m[..., :, None] * Wm + (1.0 - m[..., :, None]) * eye


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


def ring_bits(bits: torch.Tensor) -> torch.Tensor:
    """Each worker's (W,) bit as its right and left ring neighbours receive
    it: a (2, W) stack, rows in the reference's order (right, left), each
    exchange booked as a ``ppermute`` of one f32 scalar."""
    return torch.stack([comms.ppermute(bits, 1), comms.ppermute(bits, -1)])


def dpsgd_mix(bufs: list[torch.Tensor], w: float = 1.0 / 3.0, alive=None,
              rejoined=None, *, nbr_alive: torch.Tensor | None = None
              ) -> list[torch.Tensor]:
    """D-PSGD: x_i <- (1 - 2w) x_i + w (x_left + x_right), for each (W, n)
    stack of ``bufs``.

    Under churn (``alive`` (W,)): x_i <- (1 - w a_nb) x_i + w sum_nb(a x),
    a_nb the live neighbour count, for a live worker; a dead one keeps x_i.
    ``rejoined`` (``pull_avg``): a rejoiner with a live neighbour takes the
    live neighbours' mean.  ``nbr_alive``: the neighbours' alive bits
    (:func:`ring_bits`) when the caller exchanged them already, once per
    round for all its buckets."""
    out = []
    if alive is None:
        for p in bufs:  # in place on temporaries: a bucket stack is up to 2.5 GB
            wt = _scalar(w, p)
            mixed = (1 - 2 * wt) * p
            out.append(mixed.add_(_neighbor_sum(p).mul_(wt)))
        return out
    if nbr_alive is None:
        nbr_alive = ring_bits(alive)
    live_nbrs = (nbr_alive[0] + nbr_alive[1])[:, None]
    a = alive[:, None]
    for p in bufs:
        wt = _scalar(w, p)
        nbr = _neighbor_sum(a * p)
        res = torch.where(a > 0, (1 - wt * live_nbrs) * p + wt * nbr, p)
        if rejoined is not None:
            pulled = nbr / torch.clamp_min(live_nbrs, 1.0)
            res = torch.where((rejoined[:, None] > 0) & (live_nbrs > 0), pulled, res)
        out.append(res)
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
              alive=None, rejoined=None, nbr_bits: torch.Tensor | None = None
              ) -> tuple[list[torch.Tensor], ChocoState]:
    """One CHOCO-SGD round: every worker sends q = C(x - x_hat) to both
    ring neighbours; x_hat += q, the neighbour sum += the neighbours' q, and
    x <- x + gamma (w x_hat_nbr - 2w x_hat).

    ``noise(bucket, n)`` gives bucket i's uniform draws, one draw shared by
    every worker (the reference folds no worker index into the CHOCO key).
    Each worker's payload is decoded once and the decoded stack is rolled to
    the neighbours (the same values in the same additions as decoding each
    received payload), while the wire books the two payload ``ppermute``
    rounds of the reference.  The state's stacks are updated in place.

    Under churn (``alive``, ``rejoined`` (W,); both rejoin policies): a
    dead worker freezes its parameters and mirrors, and its neighbours
    weigh its payload 0; a rejoiner's payload is weighed 0 too, it snaps
    its mirror to its parameters, sends the exact delta ``x - x_hat`` to
    both neighbours and rebuilds its neighbour sum from their new mirrors,
    on dense exchanges booked under ``churn_resync``.  ``nbr_bits``: the
    (4, W) neighbour views of ``alive`` and ``rejoined`` (:func:`ring_bits`
    of each, stacked) when the caller exchanged them already, once per
    round."""
    gamma = comm.gossip_step_size if gamma is None else gamma
    if alive is not None:
        return _choco_mix_churn(compressor, noise, bufs, st, w, gamma, comp_knobs, alive,
                                rejoined, nbr_bits)
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


def choco_nbr_bits(alive: torch.Tensor, rejoined: torch.Tensor | None) -> torch.Tensor:
    """The neighbour views CHOCO-SGD's churn round exchanges once: (4, W),
    alive from the right and left, then rejoined from the right and left."""
    r = torch.zeros_like(alive) if rejoined is None else rejoined
    return torch.cat([ring_bits(alive), ring_bits(r)])


def _choco_mix_churn(compressor, noise, bufs, st, w, gamma, comp_knobs, alive, rejoined,
                     nbr_bits):
    """:func:`choco_mix`'s masked round (the reference's ``alive`` branch)."""
    if nbr_bits is None:
        nbr_bits = choco_nbr_bits(alive, rejoined)
    r = (torch.zeros_like(alive) if rejoined is None else rejoined)[:, None]
    a = alive[:, None]
    new_x = []
    for i, (p, xh, xn) in enumerate(zip(bufs, st.x_hat, st.x_hat_nbr)):
        W, n = p.shape
        kn = comp_knobs[i] if comp_knobs is not None else None
        u = noise(i, noise_len(compressor, n)) if needs_noise(compressor) else None
        q_self = torch.empty_like(p)
        for wk in range(W):
            c = compress_p(compressor, u, p[wk] - xh[wk], kn)
            q_self[wk] = decompress_p(compressor, c, kn)
        q_nbr = torch.zeros_like(p)
        for j, shift in enumerate((1, -1)):  # right, then left: the payload, key by key
            for v in c.payload.values():
                comms.book_ppermute(v, W)
            wgt = (nbr_bits[j] * (1.0 - nbr_bits[2 + j]))[:, None]
            q_nbr = q_nbr + wgt * torch.roll(q_self, shift, 0)
        xh2 = torch.where(a > 0, torch.where(r > 0, p, xh + q_self), xh)
        with comms.tag("churn_resync"):
            rd_nbr = _neighbor_sum(r * (p - xh))
            xh2_nbr = _neighbor_sum(xh2)
        xn2 = torch.where(a > 0, torch.where(r > 0, xh2_nbr, xn + q_nbr + rd_nbr), xn)
        wt, gt = _scalar(w, p), _scalar(gamma, p)
        new_x.append(torch.where(a > 0, p + gt * (wt * xn2 - 2 * wt * xh2), p))
        xh.copy_(xh2)
        xn.copy_(xn2)
    return new_x, st
