"""Plain per-expert loop of the dropping top-k MoE, the check of
``layers.moe_ffn`` at full width on the card (``chip_smoke.py`` phase F).

It shares nothing with ``moe_ffn`` but the definition: the router's
softmax in f32, each token's k most probable experts (ties to the lower
index), their probabilities renormalised; then, expert by expert, the
(token, choice) pairs routed to it in flat ``T*k`` order, of which the
first ``C = max(1, int(cf * T * k / E))`` are kept and the rest dropped;
each kept pair adds ``p * wo(silu(x wg) * (x wi))`` to its token's output.
The shared experts are the dense SwiGLU MLP.  Everything runs in f32.
"""

from __future__ import annotations

from typing import Any

import torch

f32 = torch.float32


def _swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor
            ) -> torch.Tensor:
    g = x @ wg
    return (g * torch.sigmoid(g) * (x @ wi)) @ wo


def moe_ffn_loop(p: dict[str, Any], x: torch.Tensor, *, k: int, capacity_factor: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d); ``p`` the layer's router (d, E), wi/wg (E, d, dff), wo
    (E, dff, d) and, if present, ``shared``.  Returns (y (B, S, d) f32, the
    kept token count of each expert (E,))."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d).to(f32)
    E = p["router"].shape[1]
    probs = torch.softmax(xt @ p["router"].to(f32), dim=-1)
    order = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :k]
    top = torch.gather(probs, 1, order)
    top = top / torch.clamp_min(top.sum(-1, keepdim=True), 1e-9)
    flat_e, flat_w = order.reshape(-1), top.reshape(-1)
    C = max(1, int(capacity_factor * T * k / E))
    y = torch.zeros((T, d), dtype=f32, device=x.device)
    kept = torch.zeros(E, dtype=torch.int64, device=x.device)
    for e in range(E):
        pairs = torch.nonzero(flat_e == e)[:, 0][:C]  # ascending: flat T*k order
        kept[e] = pairs.numel()
        if not pairs.numel():
            continue
        tok = pairs // k
        out = _swiglu(xt[tok], p["wi"][e].to(f32), p["wg"][e].to(f32), p["wo"][e].to(f32))
        y.index_add_(0, tok, out * flat_w[pairs, None])
    if "shared" in p:
        sp = p["shared"]
        y = y + _swiglu(xt, sp["wi"].to(f32), sp["wg"].to(f32), sp["wo"].to(f32))
    return y.reshape(B, S, d), kept
