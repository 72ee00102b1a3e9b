"""Mamba-style selective SSM head of the Hymba hybrid block
[arXiv:2411.13676] (counterpart of ``repro.models.ssm``).  Under the model
axis (``msize`` M > 1) ``d_inner`` splits over the M shards: ``w_dbc`` and
``out`` are row-parallel, their partials summed over the model axis
(booked, as the reference's two ``psum``s); the scan is per channel, so it
runs on every shard's channels at once.

The scan has no Pallas kernel in the reference (a ``lax.scan``), so it stays
plain PyTorch.  :func:`selective_scan` computes it in time chunks of
``SCAN_CHUNK`` steps, each chunk's states in closed form, so a layer makes S
/ L loop iterations instead of S; :func:`selective_scan_seq` is the
step-by-step recurrence, kept for the tests and for the decode (S = 1).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import row_parallel
from repro_torch.models.sharding import ParamDef, ShapePlan

f32 = torch.float32

DT_RANK = 16
#: steps per chunk of :func:`selective_scan`.  The chunk's pairwise decay
#: term is (B, L, L, d_inner, state) f32: 26 MB at B = 2, L = 8 and
#: hymba-1.5b's d_inner 3,200; under ``remat="full"`` a layer's backward
#: keeps S / L of them (3.4 GB at S = 1024).  The bytes moved through these
#: terms grow with L, the carry's launches with S / L
SCAN_CHUNK = 8
#: bytes of pairwise terms computed at once (a group of chunks)
SCAN_GROUP_BYTES = 1 << 29


def ssm_defs(cfg: ModelConfig, plan: ShapePlan) -> dict[str, Any]:
    d, di, st = plan.d, plan.d_inner, cfg.ssm_state
    kc = cfg.ssm_conv
    return {
        "in_x": ParamDef((d, di), shard=1),
        "in_z": ParamDef((d, di), shard=1),
        "conv": ParamDef((kc, di), init="small", shard=1),
        "conv_b": ParamDef((di,), init="zeros", shard=0),
        # dt/B/C from the post-conv stream
        "w_dbc": ParamDef((di, DT_RANK + 2 * st), init="small", shard=0),
        "dt_proj": ParamDef((DT_RANK, di), init="small", shard=1),
        "dt_bias": ParamDef((di,), init="zeros", shard=0),
        "A_log": ParamDef((di, st), init="zeros", shard=0),
        "D": ParamDef((di,), init="ones", shard=0),
        "out": ParamDef((di, d), shard=0),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B, S, di); w (kc, di); state (B, kc-1, di),
    the previous kc - 1 inputs; returns (out, the last kc - 1 inputs) in
    x's dtype."""
    kc = w.shape[0]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kc))
    # its own storage: a view would keep the whole (B, S + kc - 1, di) input
    # alive in the cache
    new_state = xp[:, x.shape[1]:].clone() if kc > 1 else state
    return out + b, new_state


def selective_scan_seq(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t``, ``y_t = C_t . h_t``, one
    step at a time, in f32: u, dt (B, S, di), A (di, st), Bm, Cm (B, S, st),
    h0 (B, di, st) -> (y (B, S, di), h_S)."""
    u, dt, Bm, Cm = (t.to(f32) for t in (u, dt, Bm, Cm))
    h = h0.to(f32)
    ys = []
    for t in range(u.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = dA * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, h0: torch.Tensor, *, chunk: int = SCAN_CHUNK
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function as :func:`selective_scan_seq`, in chunks of
    ``chunk`` steps.  Within a chunk, with ``c_t = sum_{tau <= t} dt_tau A``
    (<= 0: dt > 0 and A < 0), the states are ``h_t = exp(c_t) h_0 +
    local_t``, ``local_t = sum_{s <= t} exp(c_t - c_s) (dt_s u_s) B_s``: one
    (B, L, L, di, st) term per chunk, its s > t entries masked to -inf
    before the exp (after it, a positive exponent could overflow and turn
    the backward's products into NaN).  The local parts take no state, so
    they are computed for groups of chunks at once (``SCAN_GROUP_BYTES`` of
    pairwise terms a group); only the carry, ``h_0`` of each chunk, loops
    over the S / L chunks.  S = 1 (the decode) is one step of the
    recurrence."""
    if u.shape[1] == 1:
        return selective_scan_seq(u, dt, A, Bm, Cm, h0)
    u, dt, Bm, Cm = (t.to(f32) for t in (u, dt, Bm, Cm))
    B, S, di = u.shape
    if u.is_meta:  # shapes only (the trainer's wire trace): one chunk, no carry loop
        chunk = S
    # padded steps change nothing: dt = 0 adds -0.0 to c and nothing to h, so
    # the last chunk's last state is h_S bitwise
    pad = (-S) % chunk
    if pad:
        u, dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (u, dt, Bm, Cm))
    n = (S + pad) // chunk
    c = torch.cumsum((dt[..., None] * A).view(B, n, chunk, di, -1), dim=2)
    xB = ((dt * u)[..., None] * Bm[:, :, None, :]).view(B, n, chunk, di, -1)
    later = torch.triu(torch.ones(chunk, chunk, dtype=torch.bool, device=u.device), 1)
    later = later[:, :, None, None]  # [t, s]: s > t
    per_chunk = B * chunk * chunk * di * c.shape[-1] * 4
    group = max(1, SCAN_GROUP_BYTES // per_chunk)
    local = torch.cat([
        (torch.exp((cg[:, :, :, None] - cg[:, :, None]).masked_fill(later, float("-inf")))
         * xg[:, :, None]).sum(3)
        for cg, xg in zip(c.split(group, 1), xB.split(group, 1))], dim=1)
    decay = torch.exp(c)
    h = h0.to(f32)
    starts = []
    for dq, lq in zip(decay[:, :, -1].unbind(1), local[:, :, -1].unbind(1)):
        starts.append(h)
        h = lq + dq * h
    hs = (local + decay * torch.stack(starts, 1)[:, :, None]).view(B, n * chunk, di, -1)[:, :S]
    return torch.einsum("btds,bts->btd", hs, Cm[:, :S]), h


def ssm_block(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
              state: dict[str, torch.Tensor] | None = None, msize: int = 1
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The Mamba head on x (B, S, d): (out (B, S, d), new state).  state:
    {"conv": (B, kc-1, di) in x's dtype, "h": (B, di, st) f32}; None: a
    prompt from zero state."""
    B, S, d = x.shape
    di = p["in_x"].shape[1]
    st = cfg.ssm_state
    if state is None:
        state = {"conv": torch.zeros((B, cfg.ssm_conv - 1, di), dtype=x.dtype, device=x.device),
                 "h": torch.zeros((B, di, st), dtype=f32, device=x.device)}
    xs = torch.einsum("bsd,de->bse", x, p["in_x"])
    z = torch.einsum("bsd,de->bse", x, p["in_z"])
    xs, conv_state = _causal_conv(xs, p["conv"], p["conv_b"], state["conv"])
    xs = F.silu(xs)
    dbc = row_parallel(xs, p["w_dbc"], "bse,ek->bsk", msize)
    dt_r, Bm, Cm = torch.split(dbc, [DT_RANK, st, st], dim=-1)
    dt = F.softplus(torch.einsum("bsk,ke->bse", dt_r, p["dt_proj"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(f32))
    y, h = selective_scan(xs, dt, A, Bm, Cm, state["h"])
    y = y.to(x.dtype) + xs * p["D"]
    y = y * F.silu(z)
    out = row_parallel(y, p["out"], "bse,ed->bsd", msize)
    return out, {"conv": conv_state, "h": h}
