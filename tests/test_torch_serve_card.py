"""Serving on the card: the decode-equivalence identity of one dense and
one MLA family at full published width in f32 (TF32 off), cut to one
pattern period.  Every test here is ``gpu``-marked and skips off the card;
the module imports no jax, so it runs on a machine with the port alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_card.py

* qwen3-0.6b at 2 layers and deepseek-v2-lite-16b at its dense layer 0 and
  2 MoE layers (cf = E: no token dropped; the per-layer list layout), batch
  2, a 256-token prompt:
  ``prefill(max_seq=S+1)`` plus one ``decode_logits`` against the full
  forward's last-position logits over the S + 1 tokens, within 1e-4 of
  max|logits|, greedy tokens equal; then one ``serve_step`` (in place)
  against ``decode_step`` from the same cache: tokens and cache bitwise.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.steps import build_serve
from repro_torch.utils.tree import flatten_with_paths, tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("arch,layers", [("qwen3-0.6b", 2), ("deepseek-v2-lite-16b", 3)])
def test_full_width_decode_matches_full_forward(cuda, arch, layers):
    # the list layout: a stacked leaf is drawn at std 1/sqrt(repeats) (the
    # reference's fan-in rule), whose peaked scores amplify f32 rounding
    cfg = get_config(arch).with_updates(n_layers=layers, param_dtype="float32",
                                        compute_dtype="float32", scan_layers=False)
    if cfg.moe:
        cfg = cfg.with_updates(moe_capacity_factor=float(cfg.n_experts))
    B, S = 2, 256
    params = T.init_params(cfg, 0, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1))
                            .astype(np.int32)).to(cuda)
    with torch.inference_mode():
        _, cache = T.prefill(cfg, params, {"tokens": toks[:, :S]}, max_seq=S + 1)
        got, _ = T.decode_logits(cfg, params, cache, toks[:, S:], max_seq=S + 1)
        h, _ = T.forward_hidden(cfg, params, {"tokens": toks})
        want = L.logits_local(params["embed"], h[:, -1:], softcap=cfg.logits_softcap)
        err, top = float((got - want).abs().max()), float(want.abs().max())
        assert err <= 1e-4 * top, (err, top)
        assert torch.equal(torch.argmax(got, -1), torch.argmax(want, -1))
        want_tok, want_cache = T.decode_step(cfg, params, cache, toks[:, S:], max_seq=S + 1)
        sb = build_serve(cfg, InputShape("identity", S + 1, B, "decode"), cuda)
        tok, new_cache = sb.serve_step(params, tree_map(torch.clone, cache), toks[:, S:])
    assert torch.equal(tok, want_tok)
    for (k, a), b in zip(flatten_with_paths(new_cache).items(),
                         flatten_with_paths(want_cache).values()):
        assert torch.equal(a, b), k
