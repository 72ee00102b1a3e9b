"""Model assembly for the attention families, RWKV6, hymba, the vision
family and the encoder-decoder (counterpart of
``repro.models.transformer``: ``build_defs``, ``init_params``,
``forward_loss``, ``prefill`` and ``decode_step`` for all of them).

The tree is the reference's: ``prefix`` is the list of leading dense-FFN
layers (deepseek-v2's layer 0; empty elsewhere), unstacked; ``blocks``
holds the pattern groups (gemma3's five local layers and one global one
are the group's entries "0".."5"), each layer with ``moe`` or ``mlp``
(hymba's also with ``ssm``, its Mamba heads beside the attention; an
encoder-decoder's also with ``ln_x`` and ``xattn``, its cross-attention).
The vision and audio families add ``frontend_proj`` (d, d), which projects
the batch's precomputed ``patches`` (put before the text tokens, M-RoPE
positions on a grid) or ``frames`` (through the non-causal ``encoder``
stack and ``enc_ln_f``: the memory every decoder block cross-attends to).
With ``scan_layers=True`` the group is stacked over a leading repeats axis
(one leaf per weight, as the reference's ``lax.scan`` carries them); with
``scan_layers=False`` ``blocks`` is a list of groups.  Either way the
parameter tree, its paths and so the bucket plan match the reference's.
``remat != "none"`` recomputes each block of ``blocks`` in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
An RWKV6 block trains through kernel ``wkv6`` and its backward
``wkv6_bwd`` on the card (``ops.wkv6``; the plain scan on the CPU).

Serving keeps the reference's cache tree: ``{"prefix": [...], "pos":
int32, "blocks": ...}`` with ``blocks`` stacked over layers
(``scan_layers``) or a list of groups.  An attention block holds ``{"attn":
{"k", "v" (B, W, KV, hd), "pos" (W,) int32}}`` (MLA: ``{"lat" (B, W,
kv_lora), "rope" (B, W, qk_rope_dim), "pos"}``), a ring of W slots per
layer; a hymba block also ``"ssm": {"conv" (B, kc-1, d_inner), "h" (B,
d_inner, state) f32}``; an RWKV6 block ``{"tm": {"shift" (B, d), "wkv"
(B, H, hd, hd) f32}, "cm_last" (B, d)}``; an encoder-decoder's cache also
holds the encoder's output ``"enc_out"`` (B, S_enc, d), whose K and V each
decode step recomputes, as the reference does.

Training and serving take the reference's model axis as ``msize`` M: the
parameters are the padded-for-M tree (:func:`param_defs`), every layer runs
its M shards' local computations at once and books its collectives over
``("model",)`` (:mod:`repro_torch.models.layers`).  The decode cache keeps
the reference's global layout, its rings read as M blocks of W / M slots
(the context-parallel decode), so the stacked cache is the model-1 one; the
greedy token is the reference's packed argmax over the vocabulary shards.
Under ``cfg.seq_par`` the prefill is :func:`prefill_seqpar`.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comms
from repro_torch.models import layers as L
from repro_torch.models import rwkv as RW
from repro_torch.models import ssm as SM
from repro_torch.models.sharding import (ParamDef, ShapePlan, make_plan,
                                         materialize, stack_defs)
from repro_torch.utils.tree import leaves, unflatten_like

f32 = torch.float32


def _cross_cfg(cfg: ModelConfig) -> ModelConfig:
    """The cross-attention's config: plain GQA/MHA projections (no latent,
    no qk-norm, no bias), as the reference defines ``xattn``."""
    return cfg.with_updates(kv_lora=0, qk_norm=False, qkv_bias=False)


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder blocks' config: dense, as the reference builds them."""
    return cfg.with_updates(moe=False, family="dense", kv_lora=0)


def _block_defs(cfg: ModelConfig, plan: ShapePlan, *, moe_layer: bool, cross: bool) -> dict:
    defs = {"ln1": L.rmsnorm_def(plan.d), "ln2": L.rmsnorm_def(plan.d)}
    if cfg.family == "ssm":  # rwkv6: time-mix + channel-mix
        defs.update(RW.rwkv_defs(cfg, plan))
        return defs
    defs["attn"] = L.attn_defs(cfg, plan)
    if cfg.family == "hybrid":
        defs["ssm"] = SM.ssm_defs(cfg, plan)
    if cross:
        defs["ln_x"] = L.rmsnorm_def(plan.d)
        defs["xattn"] = L.attn_defs(_cross_cfg(cfg), plan)
    if moe_layer:
        defs["moe"] = L.moe_defs(cfg, plan)
    else:
        defs["mlp"] = L.mlp_defs(plan.d, plan.Dff)
    return defs


def build_defs(cfg: ModelConfig, plan: ShapePlan) -> dict[str, Any]:
    pat = cfg.attn_pattern
    n_rest = cfg.n_layers - cfg.first_dense_layers
    if n_rest % len(pat):
        raise ValueError(f"{cfg.name}: {n_rest} layers after the prefix do not split into "
                         f"pattern {pat}")
    repeats = n_rest // len(pat)
    cross = cfg.is_encoder_decoder

    def group():
        return {str(i): _block_defs(cfg, plan, moe_layer=cfg.moe, cross=cross)
                for i in range(len(pat))}

    defs = {
        "embed": L.embed_defs(plan),
        "ln_f": L.rmsnorm_def(plan.d),
        "prefix": [_block_defs(cfg, plan, moe_layer=False, cross=cross)
                   for _ in range(cfg.first_dense_layers)],
        "blocks": (stack_defs(group(), repeats) if cfg.scan_layers
                   else [group() for _ in range(repeats)]),
    }
    if cross:
        def enc_block():
            return _block_defs(_encoder_cfg(cfg), plan, moe_layer=False, cross=False)

        defs["encoder"] = (stack_defs(enc_block(), cfg.encoder_layers) if cfg.scan_layers
                           else [enc_block() for _ in range(cfg.encoder_layers)])
        defs["enc_ln_f"] = L.rmsnorm_def(plan.d)
    if cfg.modality in ("vision", "audio"):
        defs["frontend_proj"] = ParamDef((plan.d, plan.d), init="small")
    return defs


def param_defs(cfg: ModelConfig, msize: int = 1) -> dict[str, Any]:
    """The global ParamDef tree padded for model-axis size ``msize`` (shapes
    only, nothing allocated; each def names its sharded dimension)."""
    return build_defs(cfg, make_plan(cfg, msize))


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda",
                msize: int = 1):
    """Random parameters of the padded-for-``msize`` tree (the reference's
    ``init_params(cfg, key, msize)`` shapes, not its draws)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return materialize(param_defs(cfg, msize), gen, cfg.pdtype, device)


def make_positions(cfg: ModelConfig, B: int, S: int, device) -> torch.Tensor:
    """(3, B, S) positions, the reference's t/h/w streams: the sequential
    position in all three, except under M-RoPE with vision input, where the
    first ``n_vis = int(S * vision_fraction)`` positions (the patches) lie
    on a grid of ``side = max(1, int(sqrt(n_vis)))`` columns (t 0, h the
    row, w the column) and text position i sits at i - n_vis + side in
    all three."""
    idx = torch.arange(S, device=device)
    if cfg.rope_type == "mrope" and cfg.modality == "vision":
        n_vis = int(S * cfg.vision_fraction)
        side = max(1, int(n_vis ** 0.5))
        vis, text = idx < n_vis, idx - n_vis + side
        t = torch.where(vis, 0, text)
        h = torch.where(vis, idx // side, text)
        w = torch.where(vis, idx % side, text)
        return torch.stack([t, h, w])[:, None, :].expand(3, B, S)
    return idx.expand(3, B, S)


def _run_block(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor, *,
               attn_type: str, seq_len: int, positions: torch.Tensor,
               enc_out: torch.Tensor | None = None, causal: bool = True,
               collect_cache: bool = False, max_seq: int = 0, use_kernel: bool = True,
               msize: int = 1) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
    """One block; returns (x, the router's aux loss: 0 for an MLP or RWKV6
    block, with ``collect_cache`` the block's decode cache of capacity
    ``max_seq`` (the sequence length when 0), else None).  RWKV6 runs its
    recurrence through ``ops.wkv6`` with ``use_kernel`` (the kernels on a
    CUDA tensor), else through the plain scan; hymba adds its Mamba heads'
    output to the attention's, halved, as the reference does; a block with
    ``xattn`` adds its cross-attention to ``enc_out`` after the
    self-attention.  ``msize``: the model-axis size."""
    if cfg.family == "ssm":
        x, cache = _rwkv_layer(cfg, p, x, None, use_kernel, msize)
        return x, torch.zeros((), dtype=f32, device=x.device), cache if collect_cache else None
    window = cfg.layer_window(attn_type, seq_len)
    h_in = L.rmsnorm(p["ln1"], x)
    attn_out = L.attention(cfg, p["attn"], h_in, positions=positions, window=window,
                           causal=causal, msize=msize)
    ssm_state = None
    if "ssm" in p:
        ssm_out, ssm_state = SM.ssm_block(cfg, p["ssm"], h_in, msize=msize)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    if enc_out is not None and "xattn" in p:
        x = x + _cross_attention(cfg, p, x, enc_out, window=seq_len, msize=msize)
    h = L.rmsnorm(p["ln2"], x)
    if "moe" in p:
        ff, aux = L.moe_ffn(cfg, p["moe"], h, msize=msize)
    else:
        ff, aux = L.mlp(p["mlp"], h, msize), torch.zeros((), dtype=f32, device=x.device)
    cache = None
    if collect_cache:
        cache = {"attn": _build_cache_from_prefill(cfg, p["attn"], h_in, positions, attn_type,
                                                   max_seq or seq_len, msize)}
        if ssm_state is not None:
            cache["ssm"] = ssm_state
    return x + ff, aux, cache


def _cross_attention(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor,
                     enc_out: torch.Tensor, *, window: int, msize: int = 1) -> torch.Tensor:
    """The block's cross-attention residual: ``ln_x``, then queries from x
    and K/V from the encoder's output, no rotation, not causal.  The
    reference passes the decoder's length (training) or the encoder's
    (decode) as the window; either reaches every key."""
    return L.attention(_cross_cfg(cfg), p["xattn"], L.rmsnorm(p["ln_x"], x), positions=None,
                       window=window, causal=False, kv_source=enc_out, msize=msize)


def _build_cache_from_prefill(cfg: ModelConfig, p: dict[str, Any], h_in: torch.Tensor,
                              positions: torch.Tensor, attn_type: str,
                              max_seq: int, msize: int = 1) -> dict[str, torch.Tensor]:
    """The block's decode cache from its normed input: K and V (MLA: the
    latent and its RoPE key) recomputed from ``h_in`` and laid out as a
    ring of ``W = min(layer_window(max_seq), max_seq)`` slots, position p
    at slot p % W for the last ``min(S, W)`` positions, the other slots
    zero with pos -1.  At ``msize`` M the ring is the reference's
    context-parallel cache, shard i holding slots [i W / M, (i + 1) W / M),
    so W must split over M; KV heads sharded over the shards reach it by
    two ``all_to_all``s of one shard's (B, W, KV / M, hd) (booked)."""
    S = h_in.shape[1]
    W = min(cfg.layer_window(attn_type, max_seq), max_seq)
    if W % msize:
        raise ValueError(f"{cfg.name}: a decode ring of {W} slots does not split over "
                         f"{msize} model shards")
    fill = min(S, W)
    src = torch.arange(S - fill, S, device=h_in.device)
    slots = torch.remainder(src, W)

    def ring(t: torch.Tensor) -> torch.Tensor:
        buf = torch.zeros((t.shape[0], W, *t.shape[2:]), dtype=t.dtype, device=t.device)
        buf[:, slots] = t[:, S - fill:]
        return buf

    pos = torch.full((W,), -1, dtype=torch.int32, device=h_in.device)
    pos[slots] = src.to(torch.int32)
    if "w_dkv" in p:
        kv_lat, k_rope = L.mla_latent(cfg, p, h_in, positions)
        return {"lat": ring(kv_lat), "rope": ring(k_rope[:, :, 0]), "pos": pos}
    kk, vv = L.kv_proj(cfg, p, h_in, positions)
    kk, vv = ring(kk), ring(vv)
    if L.kv_sharded(cfg, msize):
        L.book_shard("all_to_all", kk, 2, msize)
        L.book_shard("all_to_all", vv, 2, msize)
    return {"k": kk, "v": vv, "pos": pos}


def _layer_groups(cfg: ModelConfig, blocks: Any) -> list[dict[str, Any]]:
    """Per-repeat parameter groups.  A stacked tree is split with one
    ``unbind`` per leaf, whose backward writes each leaf's gradient once."""
    if not cfg.scan_layers:
        return list(blocks)

    def split(node):
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            n = len(next(iter(parts.values())))
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return torch.unbind(node, 0)

    return split(blocks)


def _embed_inputs(cfg: ModelConfig, params: dict[str, Any],
                  batch: dict[str, torch.Tensor], msize: int = 1) -> torch.Tensor:
    """The decoder's input (B, S, d) in the compute dtype: the token
    embeddings, after the projected ``patches`` (B, S_vis, d) for vision."""
    x = L.embed(params["embed"], batch["tokens"], msize)
    if cfg.modality == "vision":
        patches = torch.einsum("bsd,de->bse", batch["patches"].to(x.dtype),
                               params["frontend_proj"])
        x = torch.cat([patches, x], dim=1)
    return x.to(cfg.dtype)


def _encode(cfg: ModelConfig, params: dict[str, Any],
            batch: dict[str, torch.Tensor], msize: int = 1) -> torch.Tensor:
    """The encoder's output (B, S_enc, d): the projected ``frames`` through
    the dense encoder blocks, self-attention not causal, then
    ``enc_ln_f``."""
    x = torch.einsum("bsd,de->bse", batch["frames"].to(cfg.dtype), params["frontend_proj"])
    B, S_enc, _ = x.shape
    positions = make_positions(cfg, B, S_enc, x.device)
    ecfg = _encoder_cfg(cfg)
    for p in _layer_groups(cfg, params["encoder"]):
        x, _, _ = _run_block(ecfg, p, x, attn_type="global", seq_len=S_enc,
                             positions=positions, causal=False, msize=msize)
    return L.rmsnorm(params["enc_ln_f"], x)


def _inputs(cfg: ModelConfig, params: dict[str, Any], batch: dict[str, torch.Tensor],
            msize: int = 1) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(the decoder's input, its positions, the encoder's output or None)."""
    x = _embed_inputs(cfg, params, batch, msize)
    positions = make_positions(cfg, x.shape[0], x.shape[1], x.device)
    return x, positions, _encode(cfg, params, batch, msize) if cfg.is_encoder_decoder else None


def _trunk(cfg: ModelConfig, params: dict[str, Any], x: torch.Tensor,
           positions: torch.Tensor, enc_out: torch.Tensor | None, *,
           use_kernel: bool = True, msize: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder stack on its input ``x`` at ``positions``: (hidden states
    after ``ln_f``, the summed router loss).  The prefix layers take
    attention type ``attn_pattern[0]``, then come the pattern groups, each
    block recomputed in the backward under ``remat``."""
    S = x.shape[1]
    pat = cfg.attn_pattern
    aux_total = torch.zeros((), dtype=f32, device=x.device)
    for p in params["prefix"]:
        x, aux, _ = _run_block(cfg, p, x, attn_type=pat[0], seq_len=S, positions=positions,
                               enc_out=enc_out, msize=msize)
        aux_total = aux_total + aux
    for pgroup in _layer_groups(cfg, params["blocks"]):
        for i, attn_type in enumerate(pat):
            kw = dict(attn_type=attn_type, seq_len=S, positions=positions, use_kernel=use_kernel,
                      msize=msize)
            if cfg.remat == "none":
                x, aux, _ = _run_block(cfg, pgroup[str(i)], x, enc_out=enc_out, **kw)
            else:
                # the block draws no random numbers: no RNG state to replay;
                # its recomputation in the backward books no collective
                x, aux = checkpoint(
                    lambda p, h, e, kw=kw: _run_block(cfg, p, h, enc_out=e, **kw)[:2],
                    pgroup[str(i)], x, enc_out, use_reentrant=False, preserve_rng_state=False,
                    context_fn=_recompute_muted)
            aux_total = aux_total + aux
    return L.rmsnorm(params["ln_f"], x), aux_total


def _recompute_muted():
    return contextlib.nullcontext(), comms.muted()


def forward_hidden(cfg: ModelConfig, params: dict[str, Any], batch: dict[str, torch.Tensor], *,
                   use_kernel: bool = True, msize: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The full forward of ``batch`` (``tokens``; vision: ``patches`` too;
    the encoder-decoder: ``frames`` too): (hidden states (B, S, d) after
    ``ln_f``, S counting the patches, the summed router loss of the MoE
    layers).  ``use_kernel``: RWKV6's recurrence through ``ops.wkv6``
    (kernels ``wkv6`` and ``wkv6_bwd`` on the card), else the plain scan;
    ``msize`` the model-axis size of the padded ``params``."""
    x, positions, enc_out = _inputs(cfg, params, batch, msize)
    return _trunk(cfg, params, x, positions, enc_out, use_kernel=use_kernel, msize=msize)


def forward_loss(cfg: ModelConfig, params: dict[str, Any], batch: dict[str, torch.Tensor], *,
                 use_kernel: bool = True, msize: int = 1
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Training forward: returns (loss, {"ce", "aux"}): ``aux`` sums the MoE
    layers' router losses, ``ce`` is the (softcapped) cross-entropy of the
    text positions (after the patches under vision) against ``labels`` and
    loss = ce + router_aux_coef * aux.  ``use_kernel`` as in
    :func:`forward_hidden`.  At ``msize`` M > 1 the loss is the
    reference's, ce + coef * aux / M, value and gradient: its fixed-up
    gradient under the model axis is this loss's, not ce + coef * aux's
    (the router's balance term trains at 1 / M strength there)."""
    x, aux_total = forward_hidden(cfg, params, batch, use_kernel=use_kernel, msize=msize)
    if cfg.modality == "vision":  # only text positions carry labels
        x = x[:, -batch["labels"].shape[1]:]
    ce = L.logits_and_loss(params["embed"], x, batch["labels"], softcap=cfg.logits_softcap,
                           msize=msize)
    loss = ce + cfg.router_aux_coef * (aux_total if msize == 1 else aux_total / msize)
    return loss, {"ce": ce, "aux": aux_total}


# ---------------------------------------------------------------------------
# Serving: prefill and one decode step.
# ---------------------------------------------------------------------------


def check_serving(cfg: ModelConfig, msize: int = 1) -> None:
    """Raise unless the port serves ``cfg`` at model-axis size ``msize``:
    what ``check_ported`` refuses, a model that does not split over
    ``msize`` shards (``make_plan``), and ``seq_par`` for what the
    reference's ``prefill_seqpar`` does not run (anything but a dense model
    of global-attention layers without leading dense layers)."""
    make_plan(cfg, msize)
    if cfg.seq_par and (cfg.family != "dense" or cfg.attn_pattern != ("global",)
                        or cfg.first_dense_layers or cfg.moe or cfg.kv_lora):
        raise NotImplementedError(
            f"{cfg.name}: the seq_par prefill runs dense models of global-attention layers "
            f"only (family {cfg.family!r}, pattern {cfg.attn_pattern})")


def _stack_groups(cfg: ModelConfig, groups: list[Any]) -> Any:
    """Per-repeat cache groups in the reference's layout: stacked over a
    leading layer axis with ``scan_layers`` (as ``lax.scan`` stacks them),
    else the list itself."""
    if not cfg.scan_layers:
        return groups
    per_group = [leaves(g) for g in groups]
    return unflatten_like(groups[0], [torch.stack(ls) for ls in zip(*per_group)])


def _rwkv_layer(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor, c: dict | None,
                use_kernel: bool, msize: int = 1) -> tuple[torch.Tensor, dict[str, Any]]:
    """One RWKV6 block: the reference's ``_run_block`` ssm branch with
    ``collect_cache`` (``c`` None: a prompt from zero state) and its
    ``_rwkv_decode_block`` (``c`` the block's cache: the shift and the
    channel mix's last token come from the stored state)."""
    h, tm_state = RW.rwkv_block(cfg, p, L.rmsnorm(p["ln1"], x), None if c is None else c["tm"],
                                use_kernel=use_kernel, msize=msize)
    x = x + h
    h, cm_last = RW.rwkv_channel_mix(cfg, p, L.rmsnorm(p["ln2"], x),
                                     None if c is None else c["cm_last"], msize)
    return x + h, {"tm": tm_state, "cm_last": cm_last}


def prefill(cfg: ModelConfig, params: dict[str, Any], batch: dict[str, torch.Tensor], *,
            max_seq: int = 0, use_kernel: bool = False,
            msize: int = 1) -> tuple[torch.Tensor, dict[str, Any]]:
    """Runs the prompt, returns (last hidden (B, d) after ``ln_f``, cache).
    ``max_seq``: the attention caches' capacity (the prompt length when 0;
    each layer's ring holds ``min(layer_window(max_seq), max_seq)`` slots,
    a multiple of ``msize``).  RWKV6 and hymba's Mamba heads carry
    recurrent states, for which ``max_seq`` has no meaning; ``use_kernel``
    runs RWKV6's recurrence through kernel ``wkv6``.  ``batch`` as in
    :func:`forward_hidden` (S counts the patches); the encoder's output
    goes into the cache as ``"enc_out"``.  ``msize``: the model-axis size
    of the padded ``params``; under ``cfg.seq_par``,
    :func:`prefill_seqpar`."""
    check_serving(cfg, msize)
    if cfg.seq_par:
        return prefill_seqpar(cfg, params, batch, max_seq=max_seq, msize=msize)
    x, positions, enc_out = _inputs(cfg, params, batch, msize)
    S = x.shape[1]
    pat = cfg.attn_pattern
    kw = dict(seq_len=S, positions=positions, enc_out=enc_out, collect_cache=True,
              max_seq=max_seq, use_kernel=use_kernel, msize=msize)
    prefix, groups = [], []
    for p in params["prefix"]:
        x, _, c = _run_block(cfg, p, x, attn_type=pat[0], **kw)
        prefix.append(c)
    for pgroup in _layer_groups(cfg, params["blocks"]):
        cs = {}
        for i, attn_type in enumerate(pat):
            x, _, cs[str(i)] = _run_block(cfg, pgroup[str(i)], x, attn_type=attn_type, **kw)
        groups.append(cs)
    cache = {"prefix": prefix, "pos": torch.full((), S, dtype=torch.int32, device=x.device),
             "blocks": _stack_groups(cfg, groups)}
    if enc_out is not None:
        cache["enc_out"] = enc_out
    x = L.rmsnorm(params["ln_f"], x)
    return x[:, -1], cache


def prefill_seqpar(cfg: ModelConfig, params: dict[str, Any], batch: dict[str, torch.Tensor],
                   *, max_seq: int = 0, msize: int = 1) -> tuple[torch.Tensor, dict[str, Any]]:
    """The sequence-parallel prefill (the reference's ``prefill_seqpar``) of a
    dense model of global layers: the activations are M sequence shards of
    S / M positions, computed at once.  Per layer, the attention keeps each
    shard's queries and gathers the K and V over the sequence
    (:func:`L.attention_seqpar`); the FFN runs each shard's tokens through
    the whole MLP, its column- and row-sharded weights all-gathered (booked
    under ``ffn_weight_gather``); each shard's sequence slice is its block
    of the cache, so the ring is the prompt, W = S.  The last position lives
    on the last shard, whose ``ln_f`` row the others' zeros join in a psum
    (booked).  S must split over M and the capacity equal S."""
    x = _embed_inputs(cfg, params, batch, msize)
    B, S, _ = x.shape
    if S % msize or (max_seq or S) != S:
        raise ValueError(f"{cfg.name}: the seq_par prefill needs a prompt ({S}) that splits "
                         f"over {msize} shards and a capacity ({max_seq or S}) equal to it")
    positions = make_positions(cfg, B, S, x.device)
    groups = []
    for pgroup in _layer_groups(cfg, params["blocks"]):
        p = pgroup["0"]
        h_in = L.rmsnorm(p["ln1"], x)
        x = x + L.attention_seqpar(cfg, p["attn"], h_in, positions=positions, msize=msize)
        if msize > 1:
            with comms.tag("ffn_weight_gather"):
                for name, dim in (("wi", 1), ("wg", 1), ("wo", 0)):
                    L.book_shard("all_gather", p["mlp"][name], dim, msize)
        x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x))
        kk, vv = L.kv_proj(cfg, p["attn"], h_in, positions)
        pos = torch.arange(S, dtype=torch.int32, device=x.device)
        groups.append({"0": {"attn": {"k": kk, "v": vv, "pos": pos}}})
    cache = {"prefix": [], "pos": torch.full((), S, dtype=torch.int32, device=x.device),
             "blocks": _stack_groups(cfg, groups)}
    last = L.rmsnorm(params["ln_f"], x)[:, -1]
    if msize > 1:
        comms.book_model("psum", last, msize)
    return last, cache


def _decode_layer(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor, c: dict[str, Any], *,
                  pos: torch.Tensor, window: int, inplace: bool,
                  enc_out: torch.Tensor | None = None,
                  msize: int = 1) -> tuple[torch.Tensor, dict[str, Any]]:
    """One attention block on one token: decode attention over the block's
    ring (hymba: and one step of its Mamba heads from the cached state; an
    encoder-decoder: then cross-attention to ``enc_out``, its K and V
    recomputed), then the MLP or the MoE (its router loss dropped; T = B
    tokens set its capacity).  ``inplace`` writes the ring slot and the new
    SSM state into ``c``'s buffers.  ``msize``: the model-axis size."""
    h_in = L.rmsnorm(p["ln1"], x)
    attn_out, ac = L.decode_attention(cfg, p["attn"], h_in, c["attn"], pos=pos, window=window,
                                      inplace=inplace, msize=msize)
    nc = {"attn": ac}
    if "ssm" in p:
        ssm_out, sc = SM.ssm_block(cfg, p["ssm"], h_in, state=c["ssm"], msize=msize)
        if inplace:
            sc = {k: c["ssm"][k].copy_(v) for k, v in sc.items()}
        nc["ssm"] = sc
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    if enc_out is not None and "xattn" in p:
        x = x + _cross_attention(cfg, p, x, enc_out, window=enc_out.shape[1], msize=msize)
    h = L.rmsnorm(p["ln2"], x)
    ff = (L.moe_ffn(cfg, p["moe"], h, msize=msize)[0] if "moe" in p
          else L.mlp(p["mlp"], h, msize))
    return x + ff, nc


def decode_logits(cfg: ModelConfig, params: dict[str, Any], cache: dict[str, Any],
                  tokens: torch.Tensor, *, max_seq: int = 0, use_kernel: bool = False,
                  inplace: bool = False, msize: int = 1) -> tuple[torch.Tensor, dict[str, Any]]:
    """One decode step from ``tokens`` (B, 1): (logits (B, 1, V) f32, new
    cache).  The attention families need ``max_seq``, which sets each
    layer's window (``layer_window(attn_type, max_seq)``); their ring slot
    ``pos % S`` is written out of place, leaving ``cache`` as it was,
    unless ``inplace``, which writes it (and hymba's new SSM and conv
    states) into ``cache``'s buffers (the caller gives ``cache`` up).
    RWKV6's state is new each step.  The decoded token's M-RoPE streams are
    all its position ``pos``, as the reference's; ``"enc_out"`` passes
    through unchanged.  ``msize``: the model-axis size of the padded
    ``params`` (the logits cover the padded vocabulary)."""
    check_serving(cfg, msize)
    if cfg.family != "ssm" and max_seq < 1:
        raise ValueError(f"{cfg.name}: decoding an attention cache needs max_seq >= 1")
    x = L.embed(params["embed"], tokens, msize).to(cfg.dtype)
    pos, enc_out = cache["pos"], cache.get("enc_out")
    pat = cfg.attn_pattern
    prefix, groups = [], []
    for p, c in zip(params["prefix"], cache["prefix"]):
        x, nc = _decode_layer(cfg, p, x, c, pos=pos, window=cfg.layer_window(pat[0], max_seq),
                              inplace=inplace, enc_out=enc_out, msize=msize)
        prefix.append(nc)
    for pgroup, cgroup in zip(_layer_groups(cfg, params["blocks"]),
                              _layer_groups(cfg, cache["blocks"])):
        ncs = {}
        for i, attn_type in enumerate(pat):
            if cfg.family == "ssm":
                x, ncs[str(i)] = _rwkv_layer(cfg, pgroup[str(i)], x, cgroup[str(i)], use_kernel,
                                             msize)
            else:
                x, ncs[str(i)] = _decode_layer(cfg, pgroup[str(i)], x, cgroup[str(i)], pos=pos,
                                               window=cfg.layer_window(attn_type, max_seq),
                                               inplace=inplace, enc_out=enc_out, msize=msize)
        groups.append(ncs)
    # written in place, the stacked leaves already hold the new slots and
    # hymba's new SSM states
    blocks = cache["blocks"] if inplace and cfg.family != "ssm" else _stack_groups(cfg, groups)
    x = L.rmsnorm(params["ln_f"], x)
    new = {"prefix": prefix, "pos": pos + 1, "blocks": blocks}
    if enc_out is not None:
        new["enc_out"] = enc_out
    return L.logits_local(params["embed"], x, softcap=cfg.logits_softcap), new


def decode_step(cfg: ModelConfig, params: dict[str, Any], cache: dict[str, Any],
                tokens: torch.Tensor, *, max_seq: int = 0, use_kernel: bool = False,
                inplace: bool = False, msize: int = 1) -> tuple[torch.Tensor, dict[str, Any]]:
    """One greedy decode step (:func:`decode_logits`). Returns (next token
    (B, 1) int32, new cache); the input cache is left as it was unless
    ``inplace``."""
    logits, cache = decode_logits(cfg, params, cache, tokens, max_seq=max_seq,
                                  use_kernel=use_kernel, inplace=inplace, msize=msize)
    return _distributed_argmax(logits, msize), cache


def _distributed_argmax(logits: torch.Tensor, msize: int = 1) -> torch.Tensor:
    """Greedy token of (B, 1, V) logits as (B, 1) int32, the reference's
    packed argmax over ``msize`` vocabulary shards of V / M: each shard's
    first maximum ``val`` at ``loc``, packed as ``f32(val) * 1e6 - f32(i)``
    for shard i; the packed values' max over the shards (booked ``pmax``);
    then ``loc + i * V / M`` summed over every shard whose packed value
    equals it (booked ``psum``).  Exactly the reference's token, ties
    included: where ``|val| * 1e6`` passes 2**24 the f32 subtraction can
    round the shard index away (at 20.0, 2e7 - 1 rounds back to 2e7), so
    two shards that tie both win and the token is the sum of their
    indices.  At one shard it is a plain argmax, the first maximum as
    ``jnp.argmax`` keeps it."""
    if msize == 1:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    blocks = logits.unflatten(-1, (msize, -1))  # (B, 1, M, V / M)
    loc = torch.argmax(blocks, dim=-1)
    val = torch.gather(blocks, -1, loc[..., None])[..., 0]
    shard = torch.arange(msize, device=logits.device)
    packed = val.to(f32) * 1e6 - shard.to(f32)
    best = torch.amax(packed, dim=-1, keepdim=True)
    comms.book_model("pmax", best[..., 0], msize)
    gidx = torch.where(packed == best, loc + shard * blocks.shape[-1], 0)
    tok = torch.sum(gidx, dim=-1).to(torch.int32)
    comms.book_model("psum", tok, msize)
    return tok
