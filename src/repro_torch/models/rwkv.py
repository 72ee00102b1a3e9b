"""RWKV6 ("Finch") block [arXiv:2404.05892] (counterpart of
``repro.models.rwkv``): attention-free time mixing with a data-dependent
decay, and the RWKV channel-mix FFN.  Under the model axis (``msize`` M >
1) the heads and the channel mix's hidden columns split over the M shards:
the recurrence runs on every shard's H / M heads in one launch (the heads
are independent), and ``wo`` and ``cm_wv`` are row-parallel, their
partials summed over the model axis (booked).

State per head: S (hd x hd, f32) with
    y_t[j]   = sum_i r_t[i] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
    S_t[i,j] = w_t[i] S_{t-1}[i,j] + k_t[i] v_t[j]
and w_t = exp(-exp(w0 + lora_w(x_t))).  Layouts are the reference's:
``wr``/``wk``/``wv``/``wg`` (d, H, hd), ``wo`` (H, hd, d), activations
(B, S, d).  The dtype steps are the reference's too: r, k, v, g in the
compute dtype, the decay widened to f32 before its exponentials, ``u``
widened to f32, and y cast back to the compute dtype before its per-head
norm.  With ``use_kernel`` the recurrence runs through ``ops.wkv6``, which
is differentiable: on the card its forward is kernel ``wkv6`` and its
backward kernel ``wkv6_bwd``, so the block trains through the kernels.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models.layers import rmsnorm, rmsnorm_def, row_parallel
from repro_torch.models.sharding import ParamDef, ShapePlan

f32 = torch.float32

#: the plain recurrence, a loop over time; the kernel's plain version too
wkv_scan = ref.wkv6


def rwkv_defs(cfg: ModelConfig, plan: ShapePlan) -> dict[str, Any]:
    d = plan.d
    H, hd = plan.rwkv_heads, plan.rwkv_hd
    lora = cfg.rwkv_decay_lora
    mix = cfg.rwkv_mix_lora
    return {
        # token-shift ddlerp: mu_x + per-channel lora-modulated interpolation
        "mu_base": ParamDef((d,), init="zeros"),
        "mu": ParamDef((5, d), init="zeros"),
        "mix_A": ParamDef((d, 5 * mix), init="small"),
        "mix_B": ParamDef((5, mix, d), init="small"),
        "wr": ParamDef((d, H, hd), shard=1),
        "wk": ParamDef((d, H, hd), shard=1),
        "wv": ParamDef((d, H, hd), shard=1),
        "wg": ParamDef((d, H, hd), shard=1),
        # decay: w0 + tanh(x A_w) B_w (per attention channel)
        "w0": ParamDef((H, hd), init="zeros", shard=0),
        "wd_A": ParamDef((d, lora), init="small"),
        "wd_B": ParamDef((lora, H, hd), init="small", shard=1),
        "u": ParamDef((H, hd), init="small", shard=0),  # bonus
        "ln_y": rmsnorm_def(hd),  # per-head group norm
        "wo": ParamDef((H, hd, d), shard=0),
        # channel mix
        "cm_mu_k": ParamDef((d,), init="zeros"),
        "cm_mu_r": ParamDef((d,), init="zeros"),
        "cm_wk": ParamDef((d, plan.Dff), shard=1),
        "cm_wv": ParamDef((plan.Dff, d), shard=0),
        "cm_wr": ParamDef((d, d)),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x: (B,S,d); last: (B,d) previous token (zero at t=0). Returns x_{t-1}."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _ddlerp(p: dict[str, Any], x: torch.Tensor, shifted: torch.Tensor) -> list[torch.Tensor]:
    """Data-dependent lerp between x_t and x_{t-1} for the 5 streams."""
    dx = shifted - x
    base = x + dx * p["mu_base"]
    mix = torch.tanh(torch.einsum("bsd,dm->bsm", base, p["mix_A"]))
    mix = mix.reshape(*mix.shape[:-1], 5, -1)
    delta = torch.einsum("bsnm,nmd->bsnd", mix, p["mix_B"])  # (B,S,5,d)
    return [x + dx * (p["mu"][i] + delta[..., i, :]) for i in range(5)]


def _last(x: torch.Tensor) -> torch.Tensor:
    """x[:, -1] in storage of its own: a view would keep the whole (B, S, d)
    activation alive in the cache."""
    return x[:, -1].clone()


def rwkv_block(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
               state: dict[str, torch.Tensor] | None = None, *,
               use_kernel: bool = False, msize: int = 1
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Time-mix sub-block. state: {"shift": (B,d), "wkv": (B,H,hd,hd) f32}.
    ``use_kernel`` runs the recurrence through ``ops.wkv6`` (the kernels on
    a CUDA tensor, forward and backward), else through the plain
    ``wkv_scan``."""
    B, S, d = x.shape
    H, hd = p["w0"].shape
    if state is None:
        state = {"shift": torch.zeros((B, d), dtype=x.dtype, device=x.device),
                 "wkv": torch.zeros((B, H, hd, hd), dtype=f32, device=x.device)}
    shifted = _token_shift(x, state["shift"])
    xr, xk, xv, xw, xg = _ddlerp(p, x, shifted)
    r = torch.einsum("bsd,dhk->bshk", xr, p["wr"])
    k = torch.einsum("bsd,dhk->bshk", xk, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xv, p["wv"])
    g = torch.einsum("bsd,dhk->bshk", xg, p["wg"])
    dec = p["w0"] + torch.einsum(
        "bsl,lhk->bshk", torch.tanh(torch.einsum("bsd,dl->bsl", xw, p["wd_A"])), p["wd_B"])
    w = torch.exp(-torch.exp(dec.to(f32)))
    if use_kernel:
        y, wkv = ops.wkv6(r, k, v, w, p["u"], state["wkv"])
    else:
        y, wkv = wkv_scan(r, k, v, w, p["u"].to(f32), state["wkv"])
    # per-head norm; eps scaled like RWKV's GroupNorm (64e-5 * head_dim basis)
    y = rmsnorm(p["ln_y"], y.to(x.dtype), eps=1e-3)
    y = y * F.silu(g)
    out = row_parallel(y, p["wo"], "bshk,hkd->bsd", msize)
    return out, {"shift": _last(x), "wkv": wkv}


def rwkv_channel_mix(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
                     last: torch.Tensor | None = None, msize: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV FFN: squared-relu key path with sigmoid receptance gate."""
    B, S, d = x.shape
    if last is None:
        last = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    shifted = _token_shift(x, last)
    dx = shifted - x
    xk = x + dx * p["cm_mu_k"]
    xr = x + dx * p["cm_mu_r"]
    kk = torch.square(F.relu(torch.einsum("bsd,df->bsf", xk, p["cm_wk"])))
    vv = row_parallel(kk, p["cm_wv"], "bsf,fd->bsd", msize)
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["cm_wr"]))
    return r * vv, _last(x)
