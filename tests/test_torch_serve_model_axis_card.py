"""Serving on the model axis on the card (gpu-marked; imports no jax and
nothing of the reference), phase SM of ``chip_smoke.py`` at a small size,
f32 with TF32 off:

* the decode-equivalence identity at model-axis size 2 for each family's
  ``reduced()`` config (the MoE at cf = E): ``prefill(max_seq=S+2)`` plus
  one ``decode_logits`` against the model-2 full forward's last-position
  logits within 1e-4 of max|logits| (qwen2-vl's forward with the decoded
  index at the decode's M-RoPE positions), and one ``serve_step`` against
  ``decode_step`` bitwise (rwkv6-3b through kernel wkv6: its layers' launches
  in the prefill and in each step);
* the model-2 server on the card against the same on the CPU: the same
  weights and prompt, the last hidden state within rtol 1e-4 / atol 1e-5 x
  max, the 4 greedy tokens equal;
* glm4-9b's seq_par prefill and decode against its model-2 baseline,
  within tests/test_seqpar.py's rtol 2e-3 / atol 2e-4, the token equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.benchmarks.common import deterministic
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data.pipeline import SyntheticBatches
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.steps import build_serve
from repro_torch.utils.tree import flatten_with_paths, tree_map

pytestmark = pytest.mark.gpu

M, S, B = 2, 24, 2
FAMILIES = ("qwen3-0.6b", "glm4-9b", "gemma3-12b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b",
            "rwkv6-3b", "hymba-1.5b", "qwen2-vl-2b", "seamless-m4t-large-v2")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _cfg(arch: str):
    cfg = get_config(arch).reduced()
    return cfg.with_updates(moe_capacity_factor=float(cfg.n_experts)) if cfg.moe else cfg


@pytest.mark.parametrize("arch", FAMILIES)
def test_model2_decode_matches_full_forward_on_card(arch, cuda):
    cfg = _cfg(arch)
    kern = cfg.family == "ssm"
    params = T.init_params(cfg, 0, cuda, M)
    full = {k: torch.from_numpy(v).to(cuda) for k, v in
            SyntheticBatches(cfg, InputShape("p", S + 1, B, "prefill"), seed=1).batch(0).items()}
    toks = full["tokens"]
    n = toks.shape[1] - 1
    ops.reset_launches()
    with torch.inference_mode(), deterministic():
        _, cache = T.prefill(cfg, params, {**full, "tokens": toks[:, :n]}, max_seq=S + M,
                             use_kernel=kern, msize=M)
        got, _ = T.decode_logits(cfg, params, cache, toks[:, n:], max_seq=S + M,
                                 use_kernel=kern, msize=M)
        if kern:
            assert ops.LAUNCHES["wkv6"] == 2 * cfg.n_layers
        if cfg.rope_type == "mrope" and cfg.modality == "vision":
            # the full forward gives the decoded index the decode's
            # positions, S in all three M-RoPE streams
            pos = T.make_positions(cfg, B, S + 1, cuda).clone()
            pos[:, :, S] = S
            h, _ = T._trunk(cfg, params, T._embed_inputs(cfg, params, full, M), pos, None,
                            msize=M)
        else:
            h, _ = T.forward_hidden(cfg, params, full, use_kernel=kern, msize=M)
        want = L.logits_local(params["embed"], h[:, -1:], softcap=cfg.logits_softcap)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
        sb = build_serve(cfg, InputShape("t", S + M, B, "decode"), cuda, msize=M)
        want_tok, want_cache = T.decode_step(cfg, params, cache, toks[:, n:], max_seq=S + M,
                                             use_kernel=True, msize=M)
        tok, new_cache = sb.serve_step(params, tree_map(torch.clone, cache), toks[:, n:])
    assert torch.equal(tok, want_tok)
    for (k, a), b in zip(flatten_with_paths(new_cache).items(),
                         flatten_with_paths(want_cache).values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-lite-16b", "rwkv6-3b"])
def test_model2_server_on_card_matches_cpu(arch, cuda):
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, 0, "cpu", M)
    batch = SyntheticBatches(cfg, InputShape("p", S, B, "prefill"), seed=1).batch(0)
    out = {}
    for dev in ("cpu", cuda):
        sb = build_serve(cfg, InputShape("t", S + 4, B, "decode"), dev, msize=M)
        p = tree_map(lambda t: t.to(dev), params)
        last, cache = sb.prefill_step(p, batch)
        tok, toks = torch.zeros((B, 1), dtype=torch.int32, device=dev), []
        for _ in range(4):
            tok, cache = sb.serve_step(p, cache, tok)
            toks.append(tok.cpu())
        out[str(dev)] = (last.cpu(), torch.cat(toks, 1))
    (l0, t0), (l1, t1) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-4,
                               atol=1e-5 * float(l0.abs().max()))
    assert torch.equal(t0, t1)


def test_seqpar_matches_baseline_on_card(cuda):
    base = get_config("glm4-9b").reduced()
    params = T.init_params(base, 0, cuda, M)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, base.vocab, (B, S + 1))
                            .astype(np.int32)).to(cuda)
    outs = []
    with torch.inference_mode():
        for seq_par in (False, True):
            cfg = base.with_updates(seq_par=seq_par)
            last, cache = T.prefill(cfg, params, {"tokens": toks[:, :S]}, msize=M)
            tok, _ = T.decode_step(cfg, params, cache, toks[:, S:], max_seq=S, msize=M)
            outs.append((last.cpu(), tok.cpu()))
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(), rtol=2e-3, atol=2e-4)
    assert torch.equal(outs[1][1], outs[0][1])
