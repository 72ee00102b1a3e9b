"""Model assembly for the dense GQA family (counterpart of
``repro.models.transformer``: ``build_defs``, ``init_params``,
``forward_loss``).

With ``scan_layers=True`` the layer group is stacked over a leading
``n_layers`` axis (one leaf per weight, as the reference's ``lax.scan``
carries them); with ``scan_layers=False`` ``blocks`` is a list of groups.
Either way the parameter tree, its paths and so the bucket plan match the
reference's.  ``remat != "none"`` recomputes each block in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import ShapePlan, make_plan, materialize, stack_defs

f32 = torch.float32


def _block_defs(cfg: ModelConfig, plan: ShapePlan) -> dict:
    return {
        "ln1": L.rmsnorm_def(plan.d),
        "ln2": L.rmsnorm_def(plan.d),
        "attn": L.attn_defs(cfg, plan),
        "mlp": L.mlp_defs(plan.d, plan.Dff),
    }


def build_defs(cfg: ModelConfig, plan: ShapePlan) -> dict[str, Any]:
    if cfg.moe or cfg.is_encoder_decoder or cfg.modality != "text" or cfg.first_dense_layers:
        raise NotImplementedError(f"{cfg.name}: only the dense text family is ported")
    pat = cfg.attn_pattern
    repeats = cfg.pattern_repeats
    defs: dict[str, Any] = {"embed": L.embed_defs(plan), "ln_f": L.rmsnorm_def(plan.d),
                            "prefix": []}
    if cfg.scan_layers:
        defs["blocks"] = stack_defs({str(i): _block_defs(cfg, plan)
                                     for i in range(len(pat))}, repeats)
    else:
        defs["blocks"] = [{str(i): _block_defs(cfg, plan) for i in range(len(pat))}
                          for _ in range(repeats)]
    return defs


def param_defs(cfg: ModelConfig) -> dict[str, Any]:
    """The ParamDef tree at model-axis size 1 (shapes only, nothing allocated)."""
    return build_defs(cfg, make_plan(cfg, 1))


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device = "cuda"):
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return materialize(param_defs(cfg), gen, cfg.pdtype, device)


def make_positions(B: int, S: int, device) -> torch.Tensor:
    """(3, B, S) positions as the reference lays them out (stream 0 is the
    sequential position; the M-RoPE streams are not ported)."""
    seq = torch.arange(S, device=device)
    return seq.expand(3, B, S)


def _run_block(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor, *,
               attn_type: str, seq_len: int, positions: torch.Tensor) -> torch.Tensor:
    window = cfg.layer_window(attn_type, seq_len)
    x = x + L.attention(cfg, p["attn"], L.rmsnorm(p["ln1"], x),
                        positions=positions, window=window)
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x))


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


def forward_loss(cfg: ModelConfig, params: dict[str, Any],
                 batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Training forward: returns (loss, {"ce", "aux"})."""
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
    B, S, _ = x.shape
    positions = make_positions(B, S, x.device)
    pat = cfg.attn_pattern
    for pgroup in _layer_groups(cfg, params["blocks"]):
        for i, attn_type in enumerate(pat):
            kw = dict(attn_type=attn_type, seq_len=S, positions=positions)
            if cfg.remat == "none":
                x = _run_block(cfg, pgroup[str(i)], x, **kw)
            else:
                # the block draws no random numbers: no RNG state to replay
                x = checkpoint(lambda p, h, kw=kw: _run_block(cfg, p, h, **kw),
                               pgroup[str(i)], x, use_reentrant=False,
                               preserve_rng_state=False)
    x = L.rmsnorm(params["ln_f"], x)
    ce = L.logits_and_loss(params["embed"], x, batch["labels"])
    aux = torch.zeros((), dtype=f32, device=x.device)  # dense family: no router loss
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}
