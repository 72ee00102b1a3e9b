"""Sparsification compressors (counterpart of
``repro.core.compression.sparsification``): Top-k, gTop-k, Random-k,
Wangni's unbiased dropping, Strom's fixed threshold, Dryden's adaptive
threshold, SBC, STC, variance-based sparsification and Spectral-ATOMO
(whose noise has the shape of the spectrum, not of the bucket).

Top-k-style methods carry ``(values, int32 indices)`` payloads of static k
and reduce by gather and scatter-add; the threshold family carries a dense
masked vector and its kept count ``nnz`` and reduces by a sum.  ``threshold``
and ``adaptive_threshold`` mask through kernel ``threshold``; the rest is
plain PyTorch, as the reference's is jnp.

Two of the reference's jnp calls are rebuilt here so that payloads stay
interchangeable: :func:`top_k` returns ``lax.top_k``'s index set in its
order (descending score, ties to the lower index), which ``torch.topk`` does
not promise; :func:`quantile` is ``jnp.quantile``'s linear method with its
f32 position (``torch.quantile`` refuses more than 2**24 elements).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.compression.base import Compressed, register
from repro_torch.kernels import ops

f32 = torch.float32


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(v), dtype=f32, device=like.device)


def k_of(n: int, ratio: float, k: int) -> int:
    """Kept elements of a top-k-style compressor: ``k`` if set, else n * ratio."""
    if k:
        return min(k, n)
    return max(1, int(n * ratio))


def top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (int64) of the k largest scores in ``lax.top_k``'s order:
    descending, ties to the lower index (a stable descending sort)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q)`` (linear method) of a flat f32 tensor, as a 0-dim
    tensor on a's device.  As jax does, the position ``q * (n - 1)`` is
    computed in f32 (so n - 1 rounds above 2**24) and clamped to ``[0, n -
    1]``, its floor and ceil index the sorted values (clamped to the last
    index, as XLA's gather clamps), and any NaN makes the result NaN.  XLA on
    the CPU contracts the interpolation into ``fma(high, w_high, low *
    w_low)``; the port takes that FMA in f64 (an exact product, the sum
    rounded to f64 and then to f32)."""
    n = a.numel()
    one = np.float32(1)
    pos = np.float32(q) * (np.float32(n) - one)
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    w_lo = one - w_hi
    top = np.float32(n) - one
    lo_i, hi_i = (min(int(min(max(v, 0), top)), n - 1) for v in (lo, hi))
    s = torch.sort(a).values
    low = s[lo_i] * _scalar(w_lo, a)
    r = (s[hi_i].double() * float(w_hi) + low.double()).to(f32)
    return torch.where(torch.isnan(a).any(), float("nan"), r)


class _Sparse:
    """``(values, indices)`` payloads, decoded as ``zeros(n).at[indices].set(values)``."""

    def decompress(self, c) -> torch.Tensor:
        values = c.payload["values"]
        out = torch.zeros(c.n, dtype=f32, device=values.device)
        out[c.payload["indices"].long()] = values
        return out


class _Masked:
    """Dense masked payloads ``{"dense", "nnz"}``, decoded as they are."""

    def decompress(self, c) -> torch.Tensor:
        return c.payload["dense"]


def _masked(dense: torch.Tensor, kept: torch.Tensor) -> Compressed:
    return Compressed({"dense": dense, "nnz": kept.to(f32).reshape(1)}, dense.numel())


@register("topk")
@dataclass
class TopK(_Sparse):
    """Deterministic top-k by magnitude."""

    ratio: float = 0.01
    k: int = 0
    unbiased: bool = False
    reduce_mode: str = "none"

    def compress(self, u, x, out=None) -> Compressed:
        idx = top_k(torch.abs(x), k_of(x.numel(), self.ratio, self.k))
        return Compressed({"values": x[idx], "indices": idx.to(torch.int32)}, x.numel())

    def wire_bits(self, n) -> float:
        return k_of(n, self.ratio, self.k) * 64.0  # 32-bit value + 32-bit index


@register("gtopk")
@dataclass
class GTopK(TopK):
    """gTop-k: local top-k on the send side; the aggregate re-sparsifies the
    worker mean to k again (``re_sparsify``, applied in the reduction)."""

    re_sparsify: bool = True


@register("randomk")
@dataclass
class RandomK(_Sparse):
    """Random-k: the top k of the uniform draws ``u``, a uniform k-subset;
    with ``scale=True`` the values are scaled by n/k (unbiased)."""

    ratio: float = 0.01
    k: int = 0
    scale: bool = True
    reduce_mode: str = "none"
    NEEDS_NOISE = True

    @property
    def unbiased(self) -> bool:
        return self.scale

    def compress(self, u, x, out=None) -> Compressed:
        n = x.numel()
        kk = k_of(n, self.ratio, self.k)
        idx = top_k(u.reshape(-1).to(device=x.device, dtype=f32), kk)
        vals = x[idx]
        if self.scale:
            vals = vals * _scalar(n / kk, vals)
        return Compressed({"values": vals, "indices": idx.to(torch.int32)}, n)

    def wire_bits(self, n) -> float:
        return k_of(n, self.ratio, self.k) * 64.0


@register("wangni")
@dataclass
class WangniSparsifier(_Masked):
    """Wangni et al.: keep coordinate i when ``u_i < p_i``, ``p_i = min(1,
    k|x_i| / sum|x|)``, and amplify it by 1/p_i; unbiased."""

    ratio: float = 0.01
    unbiased: bool = True
    reduce_mode: str = "sum"
    NEEDS_NOISE = True

    def compress(self, u, x, out=None) -> Compressed:
        k = max(1.0, x.numel() * self.ratio)
        ax = torch.abs(x)
        denom = torch.clamp_min(torch.sum(ax), 1e-30)
        p = torch.clamp_max(_scalar(k, x) * ax / denom, 1.0)
        keep = u.reshape(-1).to(device=x.device, dtype=f32) < p
        vals = torch.where(keep, x / torch.clamp_min(p, 1e-30), 0.0)
        return _masked(vals, torch.sum(keep))

    def wire_bits(self, n) -> float:
        return max(1.0, n * self.ratio) * 64.0  # expected budget


@register("threshold")
@dataclass
class FixedThreshold(_Masked):
    """Strom: drop ``|x| < tau``, through kernel ``threshold``; ``nnz`` is the
    kept count (the sum of the kernel's block counts)."""

    tau: float = 1e-3
    unbiased: bool = False
    reduce_mode: str = "sum"

    def compress(self, u, x, out=None) -> Compressed:
        dense, counts = ops.threshold_blocks(x, self.tau)
        return _masked(dense, torch.sum(counts))

    def wire_bits(self, n) -> float:
        return float("nan")  # data-dependent: read payload["nnz"]


@register("adaptive_threshold")
@dataclass
class AdaptiveThreshold(_Masked):
    """Dryden et al.: keep a fixed proportion via tau = the (1 - proportion)
    quantile of |x|, computed on x's device, then kernel ``threshold``."""

    proportion: float = 0.01
    unbiased: bool = False
    reduce_mode: str = "sum"

    def compress(self, u, x, out=None) -> Compressed:
        tau = quantile(torch.abs(x), 1.0 - self.proportion)
        dense, counts = ops.threshold_blocks(x, tau)
        return _masked(dense, torch.sum(counts))

    def wire_bits(self, n) -> float:
        return max(1.0, n * self.proportion) * 64.0


@register("sbc")
@dataclass
class SparseBinaryCompression(_Sparse):
    """Sattler et al.: top-k, then only the sign set with the larger mean
    magnitude, every kept value replaced by that mean."""

    ratio: float = 0.01
    k: int = 0
    unbiased: bool = False
    reduce_mode: str = "none"

    def compress(self, u, x, out=None) -> Compressed:
        idx = top_k(torch.abs(x), k_of(x.numel(), self.ratio, self.k))
        vals = x[idx]
        pos = vals > 0
        npos = torch.clamp_min(torch.sum(pos), 1)
        nneg = torch.clamp_min(torch.sum(~pos), 1)
        mu_pos = torch.sum(torch.where(pos, vals, 0.0)) / npos
        mu_neg = -torch.sum(torch.where(pos, 0.0, vals)) / nneg
        take_pos = mu_pos >= mu_neg
        mu = torch.where(take_pos, mu_pos, -mu_neg)
        out_vals = torch.where(pos == take_pos, mu, 0.0)
        return Compressed({"values": out_vals, "indices": idx.to(torch.int32)}, x.numel())

    def wire_bits(self, n) -> float:
        return k_of(n, self.ratio, self.k) * 33.0 + 32  # index + sign bit + shared magnitude


@register("stc")
@dataclass
class SparseTernaryCompression(_Sparse):
    """Sattler et al.: top-k, then ternarized to sign times the mean kept
    magnitude."""

    ratio: float = 0.01
    k: int = 0
    unbiased: bool = False
    reduce_mode: str = "none"

    def compress(self, u, x, out=None) -> Compressed:
        idx = top_k(torch.abs(x), k_of(x.numel(), self.ratio, self.k))
        vals = x[idx]
        mu = torch.mean(torch.abs(vals))
        return Compressed({"values": torch.sign(vals) * mu, "indices": idx.to(torch.int32)},
                          x.numel())

    def wire_bits(self, n) -> float:
        return k_of(n, self.ratio, self.k) * 34.0 + 32


@register("variance_sparse")
@dataclass
class VarianceSparsifier(_Masked):
    """Tsuzuku et al., through the reference's amplitude proxy: keep
    ``|x| > z * sigma`` (strict), sigma the population std plus 1e-30."""

    z: float = 1.0
    unbiased: bool = False
    reduce_mode: str = "sum"

    def compress(self, u, x, out=None) -> Compressed:
        sigma = torch.std(x, correction=0) + 1e-30  # jnp.std: the population std
        keep = torch.abs(x) > _scalar(self.z, x) * sigma
        return _masked(torch.where(keep, x, 0.0), torch.sum(keep))

    def wire_bits(self, n) -> float:
        return float("nan")


def _shape2d_exact(n: int) -> tuple[int, int]:
    """The squarest exact factorization r x (n / r), r <= sqrt(n)."""
    r = int(n ** 0.5)
    while n % r:
        r -= 1
    return r, n // r


@register("atomo_svd")
@dataclass
class AtomoSVD:
    """Wang et al., Spectral-ATOMO: unbiased stochastic sparsification in the
    SVD's atomic basis of x reshaped to its squarest exact factorization;
    the payload keeps the 2 * rank_budget largest kept atoms.  The SVD makes
    it a small-tensor compressor, as in the reference.  Its noise is one
    draw per singular value (``noise_len``)."""

    rank_budget: int = 4
    unbiased: bool = True
    reduce_mode: str = "none"
    NEEDS_NOISE = True

    def noise_len(self, n: int) -> int:
        return min(_shape2d_exact(n))

    def compress(self, u, x, out=None) -> Compressed:
        n = x.numel()
        U, s, Vt = torch.linalg.svd(x.reshape(_shape2d_exact(n)), full_matrices=False)
        # ATOMO probabilities: p_i = min(1, s_i * budget / sum(s))
        p = torch.clamp_max(s * self.rank_budget / torch.clamp_min(torch.sum(s), 1e-30), 1.0)
        s_hat = torch.where(u < p, s / torch.clamp_min(p, 1e-30), _scalar(0.0, s))
        r = min(self.rank_budget * 2, s.shape[0])
        order = torch.sort(-s_hat, stable=True).indices[:r]  # jnp.argsort is stable
        return Compressed({"u": U[:, order] * s_hat[order][None, :], "vt": Vt[order, :]}, n)

    def decompress(self, c) -> torch.Tensor:
        return (c.payload["u"] @ c.payload["vt"]).reshape(-1)

    def wire_bits(self, n) -> float:
        a, b = _shape2d_exact(n)
        return self.rank_budget * 2 * (a + b) * 32.0
