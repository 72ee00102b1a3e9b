"""Parameter exchange with the reference package through numpy.

The reference's parameters, flattened by path (``repro.utils.tree.
flatten_with_paths``) and exported with ``np.asarray``, become the port's
parameter tree; the inverse exports the port's tree the same way, so both
packages can compute on the same weights.  ``cache_from_numpy`` does the
same for a serving cache (the reference's ``prefill`` output), so a decode
can start from the reference's own cache.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import param_defs
from repro_torch.utils.tree import flatten_with_paths, unflatten_like


def params_from_numpy(flat: dict[str, np.ndarray], cfg: ModelConfig,
                      device: str | torch.device = "cuda") -> Any:
    defs = flatten_with_paths(param_defs(cfg))
    if set(flat) != set(defs):
        raise ValueError(f"parameter paths differ: missing {sorted(set(defs) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(defs))}")
    out = []
    for path, d in defs.items():
        # a private f32 copy: torch cannot take numpy's (ml_dtypes) bfloat16
        # arrays, and the trainer updates parameters in place
        a = np.array(flat[path], dtype=np.float32, order="C")
        if a.shape != tuple(d.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected {tuple(d.shape)}")
        out.append(torch.from_numpy(a).to(device=device, dtype=cfg.pdtype))
    return unflatten_like(param_defs(cfg), out)


def cache_from_numpy(flat: dict[str, np.ndarray], like: Any) -> Any:
    """A cache tree with ``like``'s structure, paths, dtypes and device (e.g.
    the port's own ``prefill`` cache for the same config and batch: RWKV6's
    states, or the attention rings ``k``, ``v``, ``pos`` and MLA's ``lat``,
    ``rope``, ``pos``, stacked over layers or listed), filled from ``{path:
    array}``."""
    want = flatten_with_paths(like)
    if set(flat) != set(want):
        raise ValueError(f"cache paths differ: missing {sorted(set(want) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(want))}")
    out = []
    for path, t in want.items():
        a = np.asarray(flat[path])
        if a.shape != tuple(t.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected {tuple(t.shape)}")
        a = np.array(a, dtype=np.float32 if t.is_floating_point() else a.dtype, order="C")
        out.append(torch.from_numpy(a).to(device=t.device, dtype=t.dtype))
    return unflatten_like(like, out)


def params_to_numpy(params: Any) -> dict[str, np.ndarray]:
    """``{path: array}`` of a port parameter (or gradient) tree, as f32 for
    floating leaves."""
    return {path: t.detach().to("cpu", torch.float32 if t.is_floating_point() else t.dtype)
            .numpy() for path, t in flatten_with_paths(params).items()}
