"""Transformer building blocks of the dense GQA family (counterpart of
``repro.models.layers`` at model-axis size 1).

Layouts are the reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd),
``wo`` (H, hd, d), MLP ``wi``/``wg`` (d, dff) and ``wo`` (dff, d), the
embedding (V, d).  Activations are (B, S, d).  Attention and the
projections are plain PyTorch products, as the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import ParamDef, ShapePlan

f32 = torch.float32


def rmsnorm_def(d: int) -> ParamDef:
    return ParamDef((d,), init="ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.to(f32)
    h = h * torch.rsqrt(torch.mean(torch.square(h), dim=-1, keepdim=True) + eps)
    return (h * w.to(f32)).to(x.dtype)


def _rope_cos_sin(pos: torch.Tensor, dim: int, theta: float):
    """pos (...,) -> cos/sin (..., dim//2)."""
    exps = torch.arange(0, dim, 2, dtype=f32, device=pos.device) / dim
    # torch.full, not torch.tensor: a host-to-card copy would wait for the card
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=f32, device=pos.device), exps)
    ang = pos.to(f32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., dim); cos/sin (..., dim//2) broadcastable (rotate-half pairs)."""
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (3, B, S) (stream 0 is the sequential
    position).  Only the standard branch is ported (``check_ported``)."""
    cos, sin = _rope_cos_sin(positions[0], x.shape[-1], cfg.rope_theta)
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def mlp_defs(d: int, dff: int) -> dict[str, ParamDef]:
    return {"wi": ParamDef((d, dff)), "wg": ParamDef((d, dff)), "wo": ParamDef((dff, d))}


def mlp(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    g = torch.einsum("bsd,df->bsf", x, p["wg"])
    return torch.einsum("bsf,fd->bsd", F.silu(g) * h, p["wo"])


def attn_defs(cfg: ModelConfig, plan: ShapePlan) -> dict[str, ParamDef]:
    d, H, KV, hd = plan.d, plan.H, plan.KV, plan.hd
    defs = {
        "wq": ParamDef((d, H, hd)),
        "wk": ParamDef((d, KV, hd)),
        "wv": ParamDef((d, KV, hd)),
        "wo": ParamDef((H, hd, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_def(hd)
        defs["k_norm"] = rmsnorm_def(hd)
    return defs


def sdpa_chunked(q, k, v, *, q_chunk: int = 1024) -> torch.Tensor:
    """Exact causal attention in f32 scores and softmax, over query chunks.
    q (B, S, H, hd); k, v (B, S, KV, hd); H a multiple of KV."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, group, hd)
    qc = min(q_chunk, Sq)
    if Sq % qc:
        raise ValueError(f"Sq={Sq} is not a multiple of the query chunk {qc}")
    k_pos = torch.arange(Sk, device=q.device)
    outs = []
    for i in range(Sq // qc):
        qs = qg[:, i * qc:(i + 1) * qc]
        q_pos = torch.arange(i * qc, (i + 1) * qc, device=q.device)
        s = torch.einsum("bqkgh,bskh->bkgqs", qs.to(f32) * scale, k.to(f32))
        causal = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(causal[None, None, None], s, torch.full((), -1e30, dtype=f32,
                                                                 device=s.device))
        a = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", a, v.to(f32)).to(q.dtype))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, v.shape[-1])


def attention(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor, *,
              positions: torch.Tensor, window: int) -> torch.Tensor:
    """Causal train attention over the full sequence. Returns (B, S, d)."""
    B, S, _ = x.shape
    if window < S:
        raise NotImplementedError(f"sliding-window attention (window {window} < seq {S}) "
                                  "is not ported yet")
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    kk = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        kk = rmsnorm(p["k_norm"], kk)
    q = apply_rope(cfg, q, positions)
    kk = apply_rope(cfg, kk, positions)
    # GQA: sdpa_chunked groups the query heads, so q-head h reads kv-head
    # h * KV // H, the reference's head gather, without copying K and V
    out = sdpa_chunked(q, kk, vv)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def embed_defs(plan: ShapePlan) -> dict[str, ParamDef]:
    return {"embedding": ParamDef((plan.V, plan.d), init="small")}


def embed(p: dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    V = p["embedding"].shape[0]
    ok = (ids >= 0) & (ids < V)
    vec = p["embedding"][torch.clamp(ids, 0, V - 1).long()]
    return vec * ok[..., None].to(vec.dtype)


def _chunk_loss(emb: torch.Tensor, h_c: torch.Tensor, labels_c: torch.Tensor):
    logits = torch.einsum("bsd,vd->bsv", h_c.to(f32), emb.to(f32))
    m = torch.amax(logits, dim=-1).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1)) + m
    V = emb.shape[0]
    y = torch.gather(logits, -1, torch.clamp(labels_c, 0, V - 1).long()[..., None])[..., 0]
    y = y * ((labels_c >= 0) & (labels_c < V)).to(f32)
    mask = (labels_c >= 0).to(f32)
    return torch.sum((lse - y) * mask), torch.sum(mask)


def logits_and_loss(p: dict[str, torch.Tensor], h: torch.Tensor, labels: torch.Tensor,
                    *, s_chunk: int = 1024) -> torch.Tensor:
    """Cross-entropy in f32 against the embedding; sequences longer than
    ``s_chunk`` are chunked and each chunk is recomputed in the backward, so
    the (B, S, V) f32 logits never exist at once."""
    B, S = labels.shape
    if S <= s_chunk:
        tot, cnt = _chunk_loss(p["embedding"], h, labels)
        return tot / torch.clamp(cnt, min=1.0)
    if S % s_chunk:
        raise ValueError(f"S={S} is not a multiple of s_chunk={s_chunk}")
    tot = torch.zeros((), dtype=f32, device=h.device)
    cnt = torch.zeros((), dtype=f32, device=h.device)
    for i in range(S // s_chunk):
        sl = slice(i * s_chunk, (i + 1) * s_chunk)
        t, c = checkpoint(_chunk_loss, p["embedding"], h[:, sl], labels[:, sl],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def logits_local(p: dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """Decode-time logits (B, S, V) in f32 against the embedding (the whole
    vocabulary: one card holds it all).  The reference's softcap is refused
    by ``check_ported``."""
    return torch.einsum("bsd,vd->bsv", h.to(f32), p["embedding"].to(f32))
