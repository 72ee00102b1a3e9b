"""Transformer building blocks of the attention families (counterpart of
``repro.models.layers``): GQA with standard, partial
or multimodal (M-RoPE) rotary positions, qkv bias, qk-norm and sliding
windows, causal or not, and cross-attention to an encoder's output; MLA
(deepseek-v2's compressed-latent attention); one-token decode attention
over the ring KV cache (MLA: over the latent cache); the dense SwiGLU MLP;
the capacity-buffered top-k MoE with shared experts; the embedding and the
(softcapped) cross-entropy.

Layouts are the reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd),
``wo`` (H, hd, d), biases (H, hd) / (KV, hd), MLP ``wi``/``wg`` (d, dff) and
``wo`` (dff, d), experts ``wi``/``wg`` (E, d, dff) and ``wo`` (E, dff, d),
the router (d, E), the embedding (V, d).  Activations are (B, S, d).
Attention, the projections and the expert products are plain PyTorch
products, as the reference leaves them to XLA.

The training paths take the model-axis size ``msize`` M (the reference's
``ax.model``; 1 leaves every path as it was).  The leaves are the global,
padded-for-M ones (:mod:`repro_torch.models.sharding`): a column-parallel
product over all M shards' columns is one product of the global leaf, and
the row-parallel products run on the M shards' blocks at once (a leading
shard axis), their partials summed by :func:`comms.model_psum`, booked over
``("model",)`` as the reference's ``psum``.  Padded query heads are zeroed
before ``wo``; over replicated GQA KV a padded head set reads each head's
KV head through the reference's explicit gather.  The vocabulary-parallel
embedding and loss compute on the whole padded vocabulary at once and book
the reference's ``psum``/``pmax`` of one shard's operand
(:func:`comms.book_model`).

Serving takes ``msize`` too.  The decode cache stays in the reference's
global layout, a ring of W slots of which shard i holds the block
``[i W / M, (i + 1) W / M)``; the decode reads the ring as its M blocks at
once (each block's max, their max over the shards, then the blocks' sums
added in shard order: the reference's ``pmax`` and two ``psum``s), gathers
the query heads (and the new K/V when the KV heads are sharded) and books
every collective.  Under ``cfg.seq_par`` the attention weights are
replicated and unpadded (:func:`attention_seqpar` for the prefill).
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comms
from repro_torch.models.sharding import ParamDef, ShapePlan, make_plan, shards

f32 = torch.float32


def rmsnorm_def(d: int) -> ParamDef:
    return ParamDef((d,), init="ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.to(f32)
    h = h * torch.rsqrt(torch.mean(torch.square(h), dim=-1, keepdim=True) + eps)
    return (h * w.to(f32)).to(x.dtype)


def _inv_freq(theta: float, n: int, dim: int, device) -> torch.Tensor:
    """1 / theta^(2i / dim) for i < n, in f32."""
    exps = torch.arange(0, 2 * n, 2, dtype=f32, device=device) / dim
    # torch.full, not torch.tensor: a host-to-card copy would wait for the card
    return 1.0 / torch.pow(torch.full((), theta, dtype=f32, device=device), exps)


def _rope_cos_sin(pos: torch.Tensor, dim: int, theta: float):
    """pos (...,) -> cos/sin (..., dim//2)."""
    ang = pos.to(f32)[..., None] * _inv_freq(theta, dim // 2, dim, pos.device)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., dim); cos/sin (..., dim//2) broadcastable (rotate-half pairs)."""
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (3, B, S) (t/h/w streams; stream 0 is
    the sequential position).  The standard branch; the partial one (glm4):
    the first ``int(hd * rope_fraction)`` dims (rounded down to even)
    rotate, the rest pass through; M-RoPE (qwen2-vl): the hd/2 rotary pairs
    split into ``mrope_sections`` (t, h, w), each section driven by its own
    stream, its inverse frequencies 1/theta^(2i/hd) restarting at i = 0 (the
    reference's layout, not Qwen2-VL's published interleaving)."""
    hd = x.shape[-1]
    if cfg.rope_type == "mrope":
        angles = [positions[i].to(f32)[..., None] * _inv_freq(cfg.rope_theta, sec, hd, x.device)
                  for i, sec in enumerate(cfg.mrope_sections)]
        ang = torch.cat(angles, -1)[:, :, None, :]  # (B, S, 1, hd/2)
        return _rotate(x, torch.cos(ang), torch.sin(ang))
    pos = positions[0]
    if cfg.rope_type == "partial" and cfg.rope_fraction < 1.0:
        rot = int(hd * cfg.rope_fraction)
        rot -= rot % 2
        cos, sin = _rope_cos_sin(pos, rot, cfg.rope_theta)
        x_rot = _rotate(x[..., :rot], cos[:, :, None, :], sin[:, :, None, :])
        return torch.cat([x_rot, x[..., rot:]], dim=-1)
    cos, sin = _rope_cos_sin(pos, hd, cfg.rope_theta)
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def mlp_defs(d: int, dff: int) -> dict[str, ParamDef]:
    return {"wi": ParamDef((d, dff), shard=1), "wg": ParamDef((d, dff), shard=1),
            "wo": ParamDef((dff, d), shard=0)}


def row_parallel(h: torch.Tensor, w: torch.Tensor, eq: str, msize: int, *,
                 reduce: bool = True) -> torch.Tensor:
    """``einsum(eq, h, w)`` of a row-parallel product whose contracted
    dimension is ``h``'s third (heads or hidden columns) and ``w``'s first.
    At ``msize`` M > 1 the M shards' products run at once, each on its
    block of that dimension, and ``reduce`` sums their (M, ...) partials
    over the model axis (booked); without it the partials are returned."""
    if msize == 1:
        return torch.einsum(eq, h, w)
    lhs, rest = eq.split(",")
    rhs, out = rest.split("->")
    part = torch.einsum(f"{lhs[:2]}m{lhs[2:]},m{rhs}->m{out}", h.unflatten(2, (msize, -1)),
                        shards(w, 0, msize))
    return comms.model_psum(part) if reduce else part


def mlp(p: dict[str, torch.Tensor], x: torch.Tensor, msize: int = 1, *,
        reduce: bool = True) -> torch.Tensor:
    """SwiGLU; at ``msize`` > 1 ``wi``/``wg`` column-parallel and ``wo``
    row-parallel (``reduce`` False: the (M, B, S, d) partials)."""
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    g = torch.einsum("bsd,df->bsf", x, p["wg"])
    return row_parallel(F.silu(g) * h, p["wo"], "bsf,fd->bsd", msize, reduce=reduce)


def moe_defs(cfg: ModelConfig, plan: ShapePlan) -> dict[str, Any]:
    d, E, dff = plan.d, plan.E, plan.Dff_e
    defs: dict[str, Any] = {
        "router": ParamDef((d, E), init="small"),
        "wi": ParamDef((E, d, dff), shard=0),
        "wg": ParamDef((E, d, dff), shard=0),
        "wo": ParamDef((E, dff, d), shard=0),
    }
    if plan.Dff_shared:
        defs["shared"] = mlp_defs(d, plan.Dff_shared)
    return defs


def moe_capacity(cfg: ModelConfig, T: int, capacity_factor: float | None = None) -> int:
    """Tokens each expert buffers, C = max(1, int(cf * T * k / E)), in the
    reference's float order."""
    cf = cfg.moe_capacity_factor if capacity_factor is None else capacity_factor
    return max(1, int(cf * T * cfg.experts_per_token / cfg.n_experts))


def router_top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first, ties to the lower index as
    ``lax.top_k`` orders them (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_ffn(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor, *,
            capacity_factor: float | None = None, msize: int = 1
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dropping top-k MoE (the reference's ``moe_ffn``).  Returns (out
    (B, S, d), aux).  At ``msize`` M > 1 the experts split into M shards of
    E / M; each shard's buffer holds its own experts' slots (a slot's place
    in its expert does not depend on the other experts, so the M buffers
    together are the one below and C stays global, as there), each shard
    combines its own experts' outputs with its block of the shared
    experts', and the M partials are summed over the model axis in one
    booked psum.

    The (token, choice) pairs in flat ``T*k`` order take their slot in
    their expert's buffer by a running count; the first C of each expert
    are kept, the rest go to the dummy tail row ``E * C`` (written with
    zeros, never read back).  ``aux`` is the Switch-style E * sum_e f_e P_e:
    f_e (the routed share) carries no gradient, P_e (the mean probability)
    does."""
    B, S, d = x.shape
    T, k, E = B * S, cfg.experts_per_token, cfg.n_experts
    xt = x.reshape(T, d)
    probs = torch.softmax(xt.to(f32) @ p["router"].to(f32), dim=-1)
    top_p, top_i = router_top_k(probs, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    f_e = torch.zeros(E, dtype=f32, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(T * k, dtype=f32, device=x.device)) / T
    aux = E * torch.sum(f_e * torch.mean(probs, dim=0))

    flat_e = top_i.reshape(-1)
    flat_w = top_p.reshape(-1)
    C = moe_capacity(cfg, T, capacity_factor)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    slot_in_e = torch.gather(torch.cumsum(onehot, dim=0), 1, flat_e[:, None])[:, 0] - 1
    keep = slot_in_e < C
    slot = torch.where(keep, flat_e * C + slot_in_e, E * C)
    tok = torch.arange(T * k, device=x.device) // k
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device).index_put(
        (slot,), xt[tok] * keep[:, None].to(x.dtype))
    eb = buf[:E * C].reshape(E, C, d)
    h = torch.bmm(eb, p["wi"])
    g = torch.bmm(eb, p["wg"])
    eo = torch.bmm(F.silu(g) * h, p["wo"]).reshape(E * C, d)
    eo = torch.cat([eo, torch.zeros((1, d), dtype=eo.dtype, device=eo.device)], 0)
    y = eo[slot] * (flat_w * keep.to(f32)).to(x.dtype)[:, None]
    if msize > 1:
        # each (token, choice) pair lands in the shard that owns its expert
        owner = F.one_hot(flat_e // (E // msize), msize).T.to(x.dtype)  # (M, T*k)
        y = (y[None] * owner[:, :, None]).reshape(msize, T, k, d).sum(2)
        if "shared" in p:
            y = y + mlp(p["shared"], x, msize, reduce=False).reshape(msize, T, d)
        return comms.model_psum(y).reshape(B, S, d), aux
    y = y.reshape(T, k, d).sum(1)
    if "shared" in p:
        y = y + mlp(p["shared"], x).reshape(T, d)
    return y.reshape(B, S, d), aux


def attn_defs(cfg: ModelConfig, plan: ShapePlan) -> dict[str, ParamDef]:
    d, H, KV, hd = plan.d, plan.H, plan.KV, plan.hd
    if cfg.seq_par:
        # the sequence carries the parallelism: the attention weights are
        # replicated over the model axis and not padded (the reference's
        # seq_par branch, GQA only)
        if cfg.attn_kind != "gqa" or cfg.kv_lora or cfg.moe:
            raise NotImplementedError(f"{cfg.name}: seq_par runs dense GQA attention only")
        H, KV = cfg.n_heads, cfg.n_kv_heads
        defs = {"wq": ParamDef((d, H, hd)), "wk": ParamDef((d, KV, hd)),
                "wv": ParamDef((d, KV, hd)), "wo": ParamDef((H, hd, d))}
        if cfg.qkv_bias:
            defs.update(bq=ParamDef((H, hd), init="zeros"), bk=ParamDef((KV, hd), init="zeros"),
                        bv=ParamDef((KV, hd), init="zeros"))
        if cfg.qk_norm:
            defs.update(q_norm=rmsnorm_def(hd), k_norm=rmsnorm_def(hd))
        return defs
    if cfg.kv_lora:  # MLA (deepseek-v2)
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        return {
            "wq": ParamDef((d, H, qk), shard=1),
            "w_dkv": ParamDef((d, cfg.kv_lora + cfg.qk_rope_dim)),
            "kv_norm": rmsnorm_def(cfg.kv_lora),
            "w_uk": ParamDef((cfg.kv_lora, H, cfg.qk_nope_dim), shard=1),
            "w_uv": ParamDef((cfg.kv_lora, H, cfg.v_head_dim), shard=1),
            "wo": ParamDef((H, cfg.v_head_dim, d), shard=0),
        }
    kv = 1 if plan.kv_sharded else None
    defs = {
        "wq": ParamDef((d, H, hd), shard=1),
        "wk": ParamDef((d, KV, hd), shard=kv),
        "wv": ParamDef((d, KV, hd), shard=kv),
        "wo": ParamDef((H, hd, d), shard=0),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), init="zeros", shard=0)
        defs["bk"] = ParamDef((KV, hd), init="zeros", shard=None if kv is None else 0)
        defs["bv"] = ParamDef((KV, hd), init="zeros", shard=None if kv is None else 0)
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_def(hd)
        defs["k_norm"] = rmsnorm_def(hd)
    return defs


def kv_sharded(cfg: ModelConfig, msize: int) -> bool:
    """Whether the KV heads are split over ``msize`` > 1 model shards
    (``plan.kv_sharded``; not under ``seq_par``, whose weights are
    replicated): the prefill then moves them into the sequence-sharded
    cache by ``all_to_all`` and the decode gathers the new token's K and
    V."""
    return msize > 1 and not cfg.seq_par and make_plan(cfg, msize).kv_sharded


def book_shard(kind: str, t: torch.Tensor, dim: int, msize: int) -> None:
    """Book a model-axis collective of one shard's block of the global
    ``t`` along ``dim`` (the reference's local operand)."""
    comms.book_model(kind, t.narrow(dim, 0, t.shape[dim] // msize), msize)


def window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                causal: bool = True) -> torch.Tensor:
    """(Q, K) mask of a window that counts the tokens attended to, self
    included: q - k < window, and with ``causal`` also k <= q (the
    reference's ``_window_mask``)."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = diff < window
    return ok & (diff >= 0) if causal else ok


def sdpa_chunked(q, k, v, *, window: int, causal: bool = True,
                 q_chunk: int = 1024) -> torch.Tensor:
    """Exact attention in f32 scores and softmax, over query chunks of
    ``q_chunk`` (the last one takes what is left: unlike the reference, S
    need not be a multiple of the chunk).  q (B, Sq, H, hd); k (B, Sk, KV,
    hd); v (B, Sk, KV, hd_v); H a multiple of KV; queries at positions
    0..Sq-1 and keys at 0..Sk-1, masked by :func:`window_mask`.  A causal
    windowed layer (``window`` < Sk) reads, per chunk, only the
    ``min(Sk, window + qc)`` keys that can reach it (the reference's slice,
    clipped into the sequence), not a full masked row; a non-causal one
    (the encoder, cross-attention) reads every key, as the reference
    does."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, group, hd)
    qc = min(q_chunk, Sq)
    kv_len = min(Sk, window + qc) if causal and window < Sk else Sk
    k_pos = torch.arange(Sk, device=q.device)
    neg = torch.full((), -1e30, dtype=f32, device=q.device)
    outs = []
    for q0 in range(0, Sq, qc):
        q1 = min(q0 + qc, Sq)
        qs = qg[:, q0:q1]
        q_pos = torch.arange(q0, q1, device=q.device)
        start = min(max(q1 - kv_len, 0), Sk - kv_len)
        ks, vs = k[:, start:start + kv_len], v[:, start:start + kv_len]
        s = torch.einsum("bqkgh,bskh->bkgqs", qs.to(f32) * scale, ks.to(f32))
        mask = window_mask(q_pos, k_pos[start:start + kv_len], window, causal)
        a = torch.softmax(torch.where(mask[None, None, None], s, neg), dim=-1)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", a, vs.to(f32)).to(q.dtype))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, v.shape[-1])


def kv_proj(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
            positions: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V (B, S, KV, hd) of x: biased, K qk-normed and rotated at
    ``positions`` (not rotated when None: cross-attention), as attention
    reads them and as the decode cache holds them."""
    kk = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        kk, vv = kk + p["bk"], vv + p["bv"]
    if cfg.qk_norm:
        kk = rmsnorm(p["k_norm"], kk)
    return (kk if positions is None else apply_rope(cfg, kk, positions)), vv


def _q_proj(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
            positions: torch.Tensor | None) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
    return q if positions is None else apply_rope(cfg, q, positions)


def mla_latent(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MLA's rms-normed latent (B, S, kv_lora) and its shared RoPE key
    (B, S, 1, qk_rope_dim), rotated at ``positions``: what the latent
    cache holds."""
    latent = torch.einsum("bsd,dc->bsc", x, p["w_dkv"])
    kv_lat = rmsnorm(p["kv_norm"], latent[..., :cfg.kv_lora])
    return kv_lat, apply_rope(cfg, latent[..., None, cfg.kv_lora:], positions)


def _head_out(cfg: ModelConfig, out: torch.Tensor, wo: torch.Tensor, msize: int) -> torch.Tensor:
    """The attention output (B, S, H, hd_v) through ``wo``: padded heads
    (H > n_heads) zeroed first, so their random-weight outputs never leak;
    row-parallel over the heads at ``msize`` > 1.  Under ``seq_par`` (``wo``
    replicated) the reference's shard 0 holds every head and the others
    mask theirs out (their global head ids are >= n_heads), so the psum
    (booked) adds the one full product."""
    if cfg.seq_par:
        o = torch.einsum("bshk,hkd->bsd", out, wo)
        if msize > 1:
            comms.book_model("psum", o, msize)
        return o
    H = out.shape[2]
    if H > cfg.n_heads:
        keep = torch.arange(H, device=out.device) < cfg.n_heads
        out = out * keep[None, None, :, None].to(out.dtype)
    return row_parallel(out, wo, "bshk,hkd->bsd", msize)


def attention(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor, *,
              positions: torch.Tensor | None, window: int, causal: bool = True,
              kv_source: torch.Tensor | None = None, q_chunk: int = 1024,
              msize: int = 1) -> torch.Tensor:
    """Train attention over the full sequence, ``window`` tokens back (the
    sequence length for a global layer), causal or not (the encoder), in
    query chunks of ``q_chunk``.  With ``kv_source`` (B, Sk, d), the encoder's
    output, it is cross-attention: K and V come from ``kv_source``, nothing
    is rotated and nothing is causal. Returns (B, S, d).  ``msize``: the
    model-axis size (heads column-parallel, ``wo`` row-parallel)."""
    if "w_dkv" in p:
        return _mla_attention(cfg, p, x, positions=positions, window=window, q_chunk=q_chunk,
                              msize=msize)
    rot = positions if kv_source is None else None
    q = _q_proj(cfg, p, x, rot)
    kk, vv = kv_proj(cfg, p, x if kv_source is None else kv_source, rot)
    H = q.shape[2]
    if H != cfg.n_heads and kk.shape[2] == cfg.n_kv_heads != cfg.n_heads:
        # padded query heads over replicated GQA KV: the reference's explicit
        # gather, q-head h -> kv-head min(h, n_heads - 1) * KV // n_heads
        sel = (torch.clamp_max(torch.arange(H, device=q.device), cfg.n_heads - 1)
               * cfg.n_kv_heads // cfg.n_heads)
        kk, vv = kk[:, :, sel], vv[:, :, sel]
    # GQA: sdpa_chunked groups the query heads, so q-head h reads kv-head
    # h * KV // H, the reference's head gather, without copying K and V
    out = sdpa_chunked(q, kk, vv, window=window, causal=causal and kv_source is None,
                       q_chunk=q_chunk)
    return _head_out(cfg, out, p["wo"], msize)


def _mla_attention(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor, *,
                   positions: torch.Tensor, window: int, q_chunk: int,
                   msize: int = 1) -> torch.Tensor:
    """Multi-head latent attention, training path: K and V decompressed
    from the rms-normed latent, one shared RoPE key per position."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(cfg, q[..., cfg.qk_nope_dim:], positions)
    kv_lat, k_rope = mla_latent(cfg, p, x, positions)  # k_rope (B, S, 1, rope)
    k_nope = torch.einsum("bsc,chk->bshk", kv_lat, p["w_uk"])
    v = torch.einsum("bsc,chk->bshk", kv_lat, p["w_uv"])
    H = q.shape[2]
    k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.qk_rope_dim)], -1)
    out = sdpa_chunked(torch.cat([q_nope, q_rope], -1), k, v, window=window, q_chunk=q_chunk)
    return _head_out(cfg, out, p["wo"], msize)


def attention_seqpar(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor, *,
                     positions: torch.Tensor, msize: int) -> torch.Tensor:
    """The sequence-parallel prefill's attention (the reference's
    ``attention_seqpar``) on the M sequence shards of x (B, S, d) at once:
    each shard's queries stay on it, the K and V of every shard are
    all-gathered over the sequence (booked: two ``all_gather``s of one
    shard's (B, S / M, KV, hd)), every head is local, so the query chunk is
    128 within a shard, and the replicated ``wo`` needs no psum."""
    S = x.shape[1]
    q = _q_proj(cfg, p, x, positions)
    kk, vv = kv_proj(cfg, p, x, positions)
    if msize > 1:
        book_shard("all_gather", kk, 1, msize)
        book_shard("all_gather", vv, 1, msize)
    out = sdpa_chunked(q, kk, vv, window=cfg.layer_window("global", S),
                       q_chunk=min(128, S // msize))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ---------------------------------------------------------------------------
# Decode attention over the ring cache, context-parallel over the model axis
# (the reference's decode_attention: at model-axis size 1 its all-gathers
# are identities, the cache is one shard and its LSE combine a softmax).
# ---------------------------------------------------------------------------


def _cache_write(cache: dict[str, torch.Tensor], new: dict[str, torch.Tensor],
                pos: torch.Tensor, *, inplace: bool = False) -> dict[str, torch.Tensor]:
    """Ring write of one token: each ``new[name]`` (B, ...) into slot
    ``pos % S`` of ``cache[name]`` (B, S, ...), and ``pos`` into
    ``cache["pos"]`` (S,) there.  ``pos`` is a 0-dim device tensor, so the
    slot is never read back to the host.  ``inplace`` writes into the
    cache's own buffers (the caller gives them up); otherwise the returned
    leaves are new and ``cache`` is left as it was.  The ring is the
    global one, so slot ``pos % S`` lands in the block of its owner
    ``(pos % S) // (S / M)``, where the reference's masked write puts it."""
    slot = torch.remainder(pos, cache["pos"].shape[0]).reshape(1).long()
    out = dict(cache)
    upd = {name: (1, t[:, None].to(cache[name].dtype)) for name, t in new.items()}
    upd["pos"] = (0, pos.reshape(1).to(torch.int32))
    for name, (dim, t) in upd.items():
        out[name] = (cache[name].index_copy_(dim, slot, t) if inplace
                     else cache[name].index_copy(dim, slot, t))
    return out


def _cache_valid(cache_pos: torch.Tensor, pos: torch.Tensor, window: int) -> torch.Tensor:
    """(S,) slots a query at ``pos`` reads: filled, not ahead of it, and
    within ``window`` tokens back (self included)."""
    return (cache_pos >= 0) & (cache_pos <= pos) & (cache_pos > pos - window)


def _softmax_read(s: torch.Tensor, v: torch.Tensor, eq: str, msize: int = 1) -> torch.Tensor:
    """The reference's ``_partial_softmax_combine``: the masked scores ``s``
    (..., S) against the ring ``v`` (B, S, ...), contracted by ``eq`` (the
    sequence letter last in ``s``), over the clamped sum of the
    exponentials, in f32.  At ``msize`` M > 1 the ring is its M shards'
    blocks of S / M slots: each block's max, their max (the ``pmax``), then
    each block's sum of ``exp(s - m)`` and its product with ``v``, both
    added over the blocks in shard order (the two ``psum``s); all booked,
    every block in one launch."""
    if msize == 1:
        e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        o = torch.einsum(eq, e, v.to(f32))
        return o / torch.clamp_min(torch.sum(e, dim=-1, keepdim=True), 1e-30)
    lhs, rest = eq.split(",")
    rhs, out = rest.split("->")
    t = lhs[-1]
    blocked = f"{lhs[:-1]}m{t},{rhs.replace(t, 'm' + t)}->m{out}"
    sb = s.unflatten(-1, (msize, -1))
    m_loc = torch.amax(sb, dim=-1, keepdim=True)
    m = torch.amax(m_loc, dim=-2, keepdim=True)
    e = torch.exp(sb - m)
    l_parts = torch.sum(e, dim=-1)  # (..., M)
    o_parts = torch.einsum(blocked, e, v.to(f32).unflatten(1, (msize, -1)))
    l, o = l_parts[..., :1], o_parts[0]
    for i in range(1, msize):
        l, o = l + l_parts[..., i:i + 1], o + o_parts[i]
    comms.book_model("pmax", m_loc[..., 0, :], msize)
    comms.book_model("psum", l, msize)
    comms.book_model("psum", o, msize)
    return o / torch.clamp_min(l, 1e-30)


def decode_attention(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
                     cache: dict[str, torch.Tensor], *, pos: torch.Tensor, window: int,
                     inplace: bool = False, msize: int = 1
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token attention of x (B, 1, d) at position ``pos`` (0-dim int32
    tensor) over the ring cache ``{"k", "v" (B, S, KV, hd), "pos" (S,)
    int32, -1 empty}`` (MLA: ``{"lat" (B, S, kv_lora), "rope" (B, S,
    qk_rope_dim), "pos"}``).  The token's K and V are written first
    (:func:`_cache_write`), then every valid slot is read: scores in f32,
    masked to -1e30.  Returns (out (B, 1, d), the written cache).

    At ``msize`` M > 1, as the reference's shards: the query heads are
    gathered (not under ``seq_par``), and the new K and V when the KV heads
    are sharded (:func:`kv_sharded`); over replicated GQA KV only the
    ``n_heads`` real heads read the cache, else all ``H_pad`` in aligned
    groups; the padded heads are masked, and the M shards' head slices go
    through the row-parallel ``wo`` (under ``seq_par``, the replicated
    ``wo``: no psum)."""
    if "w_dkv" in p:
        return _mla_decode(cfg, p, x, cache, pos=pos, window=window, inplace=inplace,
                           msize=msize)
    B = x.shape[0]
    pos3 = pos.expand(3, B, 1)
    q = _q_proj(cfg, p, x, pos3)
    kk, vv = kv_proj(cfg, p, x, pos3)
    if msize > 1:
        if not cfg.seq_par:
            book_shard("all_gather", q, 2, msize)
        if kv_sharded(cfg, msize):
            book_shard("all_gather", kk, 2, msize)
            book_shard("all_gather", vv, 2, msize)
    cache = _cache_write(cache, {"k": kk[:, 0], "v": vv[:, 0]}, pos, inplace=inplace)
    valid = _cache_valid(cache["pos"], pos, window)
    q = q[:, 0]
    H, hd = q.shape[1], q.shape[2]
    KV = cache["k"].shape[2]
    # replicated GQA KV: the real heads (they come first) in groups of
    # n_heads / KV; else (MHA, sharded KV) all heads in aligned groups.  Either
    # way q-head h reads kv-head h // group, as in training
    eff = cfg.n_heads if KV == cfg.n_kv_heads != cfg.n_heads else H
    qg = q[:, :eff].reshape(B, KV, eff // KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.to(f32) * hd ** -0.5, cache["k"].to(f32))
    s = torch.where(valid, s, torch.full((), -1e30, dtype=f32, device=s.device))
    ctx = _softmax_read(s, cache["v"], "bkgs,bskh->bkgh", msize)
    ctx = ctx.reshape(B, 1, eff, hd).to(x.dtype)
    if cfg.seq_par:
        return torch.einsum("bshk,hkd->bsd", ctx, p["wo"]), cache
    if eff < H:
        ctx = F.pad(ctx, (0, 0, 0, H - eff))
    return _head_out(cfg, ctx, p["wo"], msize), cache


def _mla_decode(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
                cache: dict[str, torch.Tensor], *, pos: torch.Tensor, window: int,
                inplace: bool, msize: int = 1
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """MLA over the latent cache: ``w_uk`` absorbed into q, scores over the
    latents plus the shared RoPE keys in f32, the softmax-weighted latent
    decompressed by ``w_uv`` in f32, then ``wo``.  At ``msize`` > 1 the
    absorbed queries and their RoPE parts are gathered over the heads
    (booked), the ``n_heads`` real heads read the ring, the latent context
    is padded back to ``H_pad`` and each shard's heads go through its
    ``w_uv`` and row-parallel ``wo`` blocks."""
    B = x.shape[0]
    pos3 = pos.expand(3, B, 1)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(cfg, q[..., cfg.qk_nope_dim:], pos3)
    kv_lat, k_rope = mla_latent(cfg, p, x, pos3)
    q_lat = torch.einsum("bshn,chn->bshc", q_nope, p["w_uk"])  # (B, 1, H, c)
    if msize > 1:
        book_shard("all_gather", q_lat, 2, msize)
        book_shard("all_gather", q_rope, 2, msize)
    cache = _cache_write(cache, {"lat": kv_lat[:, 0], "rope": k_rope[:, 0, 0]}, pos,
                        inplace=inplace)
    valid = _cache_valid(cache["pos"], pos, window)
    H, nh = q_lat.shape[2], cfg.n_heads
    s = torch.einsum("bhc,btc->bht", q_lat[:, 0, :nh].to(f32), cache["lat"].to(f32))
    s = s + torch.einsum("bhr,btr->bht", q_rope[:, 0, :nh].to(f32), cache["rope"].to(f32))
    s = s * (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    s = torch.where(valid, s, torch.full((), -1e30, dtype=f32, device=s.device))
    ctx_lat = _softmax_read(s, cache["lat"], "bht,btc->bhc", msize)
    if nh < H:
        ctx_lat = F.pad(ctx_lat, (0, 0, 0, H - nh))
    v_ctx = torch.einsum("bhc,chn->bhn", ctx_lat, p["w_uv"].to(f32)).to(x.dtype)
    return row_parallel(v_ctx[:, None], p["wo"], "bshk,hkd->bsd", msize), cache


def embed_defs(plan: ShapePlan) -> dict[str, ParamDef]:
    return {"embedding": ParamDef((plan.V, plan.d), init="small", shard=0)}


def embed(p: dict[str, torch.Tensor], ids: torch.Tensor, msize: int = 1) -> torch.Tensor:
    """Embedding lookup; ids outside the vocabulary read zeros.  At
    ``msize`` > 1 the vocabulary is split over the model axis: each shard's
    lookup reads zeros for the ids it does not hold, so the psum of the M
    lookups (booked) is the one lookup of the whole table."""
    V = p["embedding"].shape[0]
    ok = (ids >= 0) & (ids < V)
    vec = p["embedding"][torch.clamp(ids, 0, V - 1).long()]
    vec = vec * ok[..., None].to(vec.dtype)
    if msize > 1:
        comms.book_model("psum", vec, msize)
    return vec


def _softcap(logits: torch.Tensor, softcap: float) -> torch.Tensor:
    return softcap * torch.tanh(logits / softcap) if softcap else logits


def _chunk_loss(emb: torch.Tensor, h_c: torch.Tensor, labels_c: torch.Tensor,
                softcap: float = 0.0, msize: int = 1):
    """One chunk's summed cross-entropy and label count.  At ``msize`` > 1
    (the vocabulary-parallel loss) the exponentials are summed within each
    shard's block of the vocabulary, then over the shards; the max, the sum
    and the label's logit are booked as the reference's ``pmax`` and two
    ``psum``s over the model axis."""
    logits = _softcap(torch.einsum("bsd,vd->bsv", h_c.to(f32), emb.to(f32)), softcap)
    m = torch.amax(logits, dim=-1).detach()
    e = torch.exp(logits - m[..., None])
    if msize > 1:
        comms.book_model("pmax", m, msize)
        comms.book_model("psum", m, msize)
        comms.book_model("psum", m, msize)
        e = e.unflatten(-1, (msize, -1)).sum(-1)
    lse = torch.log(torch.sum(e, dim=-1)) + m
    V = emb.shape[0]
    y = torch.gather(logits, -1, torch.clamp(labels_c, 0, V - 1).long()[..., None])[..., 0]
    y = y * ((labels_c >= 0) & (labels_c < V)).to(f32)
    mask = (labels_c >= 0).to(f32)
    return torch.sum((lse - y) * mask), torch.sum(mask)


def logits_and_loss(p: dict[str, torch.Tensor], h: torch.Tensor, labels: torch.Tensor,
                    *, softcap: float = 0.0, s_chunk: int = 1024,
                    msize: int = 1) -> torch.Tensor:
    """Cross-entropy in f32 against the embedding, the logits softcapped
    (``softcap * tanh(logits / softcap)``) when ``softcap`` is set;
    sequences longer than ``s_chunk`` are chunked and each chunk is
    recomputed in the backward, so the (B, S, V) f32 logits never exist at
    once.  ``msize``: the model-axis size (vocabulary-parallel); the
    chunks' collectives are booked once, as the reference books its scan
    body once."""
    B, S = labels.shape
    if S <= s_chunk:
        tot, cnt = _chunk_loss(p["embedding"], h, labels, softcap, msize)
        return tot / torch.clamp(cnt, min=1.0)
    if S % s_chunk:
        raise ValueError(f"S={S} is not a multiple of s_chunk={s_chunk}")
    tot = torch.zeros((), dtype=f32, device=h.device)
    cnt = torch.zeros((), dtype=f32, device=h.device)
    for i in range(S // s_chunk):
        sl = slice(i * s_chunk, (i + 1) * s_chunk)
        with comms.muted(i > 0):
            # the recomputation in the backward books nothing
            t, c = checkpoint(_chunk_loss, p["embedding"], h[:, sl], labels[:, sl], softcap,
                              msize, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), comms.muted()))
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def logits_local(p: dict[str, torch.Tensor], h: torch.Tensor, *,
                 softcap: float = 0.0) -> torch.Tensor:
    """Decode-time logits (B, S, V) in f32 against the embedding, softcapped
    as in training: the whole padded vocabulary, which under the model axis
    is the M shards' local logits side by side (no collective; the greedy
    token's is :func:`repro_torch.models.transformer._distributed_argmax`)."""
    return _softcap(torch.einsum("bsd,vd->bsv", h.to(f32), p["embedding"].to(f32)), softcap)
