"""The sequence-parallel prefill and its decode (``cfg.seq_par``) on the
model axis, glm4-9b ``reduced()`` (f32; 4 heads over 2 KV heads, so the
KV stays replicated at 4 shards):

* against the reference's ``build_serve`` on a 1 x 4 mesh in one 4-device
  subprocess, capacity = prompt (as the reference's launcher sets it): the
  prefill's last hidden state and every cache leaf, then 4 greedy steps
  from the reference's cache, tokens equal, caches and hidden within rtol
  1e-5 / atol 1e-6 x max, the booked records of the prefill (the K/V
  all-gathers, ``ffn_weight_gather``, the last row's psum) and of one step
  equal to the reference's capture;
* against the port's own baseline at 4 shards on the same values (the
  reference's ``tests/test_seqpar.py``): the last hidden state within its
  rtol 2e-3 / atol 2e-4, the next token equal;
* ``launch/serve.py --seq-par --model 4`` and the refusals of what the
  reference's ``prefill_seqpar`` does not run.
"""

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.train.steps import build_serve
from test_torch_serve_model_axis_ref import (B, S, prompt, run_reference,
                                             serve_matches_reference)
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

M = 4
ARCH = "glm4-9b"
SEQPAR = {"seq_par": True}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("seqpar_ref")
    return out, run_reference({ARCH: SEQPAR}, out, n_devices=M, msize=M, cap=S)


def test_seqpar_prefill_and_decode_match_reference(reference):
    out, ref = reference
    serve_matches_reference(ARCH, SEQPAR, out, ref["archs"][ARCH], msize=M, cap=S)


def test_seqpar_matches_the_baseline():
    """The same values through the seq_par prefill and decode and through
    the baseline (heads column-parallel, the ring sequence-sharded) at 4
    shards: glm4's reduced trees coincide (no head padding, replicated
    KV)."""
    base = get_config(ARCH).reduced()
    params = T.init_params(base, 0, "cpu", M)
    flat = interop.params_to_numpy(params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, base.vocab, (B, S + 1))
                            .astype(np.int32))
    outs = {}
    for mode in ("baseline", "seqpar"):
        cfg = base.with_updates(seq_par=mode == "seqpar")
        p = interop.params_from_numpy(flat, cfg, "cpu", M)
        with torch.inference_mode():
            last, cache = T.prefill(cfg, p, {"tokens": toks[:, :S]}, msize=M)
            tok, _ = T.decode_step(cfg, p, cache, toks[:, S:], max_seq=S, msize=M)
        outs[mode] = (last, tok)
    np.testing.assert_allclose(outs["seqpar"][0].numpy(), outs["baseline"][0].numpy(),
                               rtol=2e-3, atol=2e-4)
    assert torch.equal(outs["seqpar"][1], outs["baseline"][1])


def test_seqpar_launcher_and_refusals(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--model", str(M),
                       "--seq-par", "--prompt-len", "16", "--batch", "2", "--decode", "3"]) == 0
    assert capsys.readouterr().out.splitlines()[1].startswith("decoded 3 tokens/seq")
    for arch in ("gemma3-12b", "qwen3-moe-30b-a3b", "rwkv6-3b", "hymba-1.5b"):
        cfg = get_config(arch).reduced().with_updates(seq_par=True)
        with pytest.raises(NotImplementedError, match="seq_par"):
            build_serve(cfg, InputShape("t", S, B, "decode"), "cpu", msize=2)
    cfg = get_config(ARCH).reduced().with_updates(seq_par=True)
    params = T.init_params(cfg, 0, "cpu", M)
    batch = {k: torch.from_numpy(v) for k, v in prompt(cfg).items()}
    with pytest.raises(ValueError, match="capacity"):  # the ring must hold the prompt
        T.prefill(cfg, params, batch, max_seq=S + 4, msize=M)
    with pytest.raises(ValueError, match="splits"):  # 24 over 5 shards
        T.prefill(cfg, T.init_params(cfg, 0, "cpu", 1), batch, msize=5)
