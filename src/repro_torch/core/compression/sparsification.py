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

The convergence engine's ``roundtrip_p`` takes a (rows, dim) stack with
per-row knobs, as the reference's does per worker under ``jax.vmap``: the
selection knobs (k, ratio, tau, proportion, z, rank budget) are values, so
k-selection is a rank mask (:func:`topk_mask`: a stable sort's ranks
against each row's k), and the threshold family is plain ``where``, as in
the reference (no kernel on this path).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.compression.base import Compressed, measured_wire_bits, register
from repro_torch.core.compression.quantization import knob
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


def topk_mask(score: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Mask of each row's ``k`` largest scores ((rows, dim) scores, (rows, 1)
    k): a stable descending sort breaks ties by index, as ``lax.top_k`` and
    the reference's argsort mask do."""
    order = torch.argsort(-score, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(score.shape[-1], device=score.device)
                  .expand_as(order).contiguous())
    return rank < k


def quantile_rows(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The linear-method quantile ``q`` ((rows, 1) f32) of each row of a
    (rows, dim) stack, as a (rows, 1) column: the position ``q * (dim - 1)``
    in f32, clamped to [0, dim - 1], interpolates the sorted row."""
    d = a.shape[-1]
    pos = torch.clamp(q * (d - 1.0), 0.0, d - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    s = torch.sort(a, dim=-1).values
    low = torch.gather(s, -1, lo.long()) * (1.0 - w_hi)
    return torch.gather(s, -1, torch.clamp_max(hi, d - 1.0).long()) * w_hi + low


class _TopKRows:
    """``roundtrip_p`` of the plain top-k family: keep each row's k largest
    magnitudes."""

    BATCH_KNOBS = ("ratio", "k")

    def batch_params(self, dim: int) -> dict:
        return {"k": k_of(dim, self.ratio, self.k)}

    def _k(self, p, x) -> torch.Tensor:
        return knob(p, "k", k_of(x.shape[1], self.ratio, self.k), x)


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
class TopK(_TopKRows, _Sparse):
    """Deterministic top-k by magnitude."""

    ratio: float = 0.01
    k: int = 0
    unbiased: bool = False
    reduce_mode: str = "none"

    def roundtrip_p(self, u, x, p):
        k = self._k(p, x)
        return torch.where(topk_mask(torch.abs(x), k), x, 0.0), (k * 64.0)[:, 0]

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
class RandomK(_TopKRows, _Sparse):
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

    def roundtrip_p(self, u, x, p):
        k = self._k(p, x)
        vals = x * (x.shape[1] / k) if self.scale else x
        return torch.where(topk_mask(u, k), vals, 0.0), (k * 64.0)[:, 0]

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
    BATCH_KNOBS = ("ratio",)

    def roundtrip_p(self, u, x, p):
        k = torch.clamp_min(x.shape[1] * knob(p, "ratio", self.ratio, x), 1.0)
        denom = torch.clamp_min(torch.sum(torch.abs(x), dim=-1, keepdim=True), 1e-30)
        prob = torch.clamp_max(k * torch.abs(x) / denom, 1.0)
        vals = torch.where(u < prob, x / torch.clamp_min(prob, 1e-30), 0.0)
        return vals, (k * 64.0)[:, 0]  # the expected budget, as wire_bits

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
    BATCH_KNOBS = ("tau",)

    def roundtrip_p(self, u, x, p):
        """The reference's engine path is a plain where, not the kernel."""
        out = torch.where(torch.abs(x) >= knob(p, "tau", self.tau, x), x, 0.0)
        return out, measured_wire_bits(out)

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
    BATCH_KNOBS = ("proportion",)

    def roundtrip_p(self, u, x, p):
        pi = knob(p, "proportion", self.proportion, x)
        ax = torch.abs(x)
        out = torch.where(ax >= quantile_rows(ax, 1.0 - pi), x, 0.0)
        return out, (torch.clamp_min(x.shape[1] * pi, 1.0) * 64.0)[:, 0]

    def compress(self, u, x, out=None) -> Compressed:
        tau = quantile(torch.abs(x), 1.0 - self.proportion)
        dense, counts = ops.threshold_blocks(x, tau)
        return _masked(dense, torch.sum(counts))

    def wire_bits(self, n) -> float:
        return max(1.0, n * self.proportion) * 64.0


@register("sbc")
@dataclass
class SparseBinaryCompression(_TopKRows, _Sparse):
    """Sattler et al.: top-k, then only the sign set with the larger mean
    magnitude, every kept value replaced by that mean."""

    ratio: float = 0.01
    k: int = 0
    unbiased: bool = False
    reduce_mode: str = "none"

    def roundtrip_p(self, u, x, p):
        k = self._k(p, x)
        kmask = topk_mask(torch.abs(x), k)
        pos = kmask & (x > 0)
        neg = kmask & ~(x > 0)
        npos = torch.clamp_min(pos.sum(-1, keepdim=True), 1)
        nneg = torch.clamp_min(neg.sum(-1, keepdim=True), 1)
        mu_pos = torch.where(pos, x, 0.0).sum(-1, keepdim=True) / npos
        mu_neg = -torch.where(neg, x, 0.0).sum(-1, keepdim=True) / nneg
        take_pos = mu_pos >= mu_neg
        mu = torch.where(take_pos, mu_pos, -mu_neg)
        out = torch.where(kmask & ((x > 0) == take_pos), mu, 0.0)
        return out, (k * 33.0 + 32)[:, 0]

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
class SparseTernaryCompression(_TopKRows, _Sparse):
    """Sattler et al.: top-k, then ternarized to sign times the mean kept
    magnitude."""

    ratio: float = 0.01
    k: int = 0
    unbiased: bool = False
    reduce_mode: str = "none"

    def roundtrip_p(self, u, x, p):
        k = self._k(p, x)
        kmask = topk_mask(torch.abs(x), k)
        mu = torch.where(kmask, torch.abs(x), 0.0).sum(-1, keepdim=True) / k
        return torch.where(kmask, torch.sign(x) * mu, 0.0), (k * 34.0 + 32)[:, 0]

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
    BATCH_KNOBS = ("z",)

    def roundtrip_p(self, u, x, p):
        sigma = torch.std(x, dim=-1, correction=0, keepdim=True) + 1e-30
        out = torch.where(torch.abs(x) > knob(p, "z", self.z, x) * sigma, x, 0.0)
        return out, measured_wire_bits(out)

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
    BATCH_KNOBS = ("rank_budget",)

    def roundtrip_p(self, u, x, p):
        """Row stack: one batched SVD; the payload truncation keeps each
        row's 2 * budget largest kept atoms."""
        budget = knob(p, "rank_budget", self.rank_budget, x)
        rows, n = x.shape
        a, b = _shape2d_exact(n)
        U, s, Vt = torch.linalg.svd(x.reshape(rows, a, b), full_matrices=False)
        prob = torch.clamp_max(s * budget / torch.clamp_min(s.sum(-1, keepdim=True), 1e-30),
                               1.0)
        s_hat = torch.where(u < prob, s / torch.clamp_min(prob, 1e-30), 0.0)
        s_hat = torch.where(topk_mask(s_hat, 2 * budget), s_hat, 0.0)
        out = ((U * s_hat[:, None, :]) @ Vt).reshape(rows, n)
        return out, (2 * budget * (a + b) * 32.0)[:, 0]

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
