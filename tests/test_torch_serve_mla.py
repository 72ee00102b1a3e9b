"""Serving the MoE and MLA families against the JAX package (the dense
ones and the port's own identity are in ``test_torch_serve.py``, whose
harness this module reuses): qwen3-moe-30b-a3b and deepseek-v2-lite-16b
(MLA's latent cache, its dense layer 0, shared experts) through both
packages' ``build_serve``, prefill caches rtol 1e-5 / atol 1e-5 x
max|want|, 6 greedy steps from the reference's own cache with tokens
equal.

The MoE decodes at its default capacity factor: with T = B = 2 tokens a
step, C = max(1, int(1.25 * 2 * 2 / 4)) = 1 slot per expert, so two tokens
that pick one expert drop a choice, as the reference's decode does; the
tests count those drops and require some.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from test_torch_serve import B, serve_matches_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)


@pytest.mark.parametrize("arch,scan_layers", [("qwen3-moe-30b-a3b", False),
                                              ("deepseek-v2-lite-16b", False),
                                              ("deepseek-v2-lite-16b", True)])
def test_prefill_and_decode_match_reference(arch, scan_layers, monkeypatch):
    cfg = get_config(arch).reduced()
    moe_ffn, drops = L.moe_ffn, []

    def counted(cfg_, p, x, **kw):
        """moe_ffn, counting the (token, choice) pairs a decode step drops."""
        if x.shape[:2] == (B, 1):
            probs = torch.softmax(x.reshape(B, -1).to(torch.float32)
                                  @ p["router"].to(torch.float32), dim=-1)
            _, top_i = L.router_top_k(probs, cfg_.experts_per_token)
            per_e = torch.bincount(top_i.reshape(-1), minlength=cfg_.n_experts)
            drops.append(int(torch.clamp_min(per_e - L.moe_capacity(cfg_, B), 0).sum()))
        return moe_ffn(cfg_, p, x, **kw)

    monkeypatch.setattr(L, "moe_ffn", counted)
    serve_matches_reference(arch, scan_layers)
    assert L.moe_capacity(cfg, B) == 1 and sum(drops) > 0, drops


def test_serve_launcher_runs_mla(capsys):
    assert launch_serve.main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--device", "cpu",
                              "--prompt-len", "16", "--batch", "2", "--decode", "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 16x2: ") and lines[1].startswith("decoded 5 tokens")
    sample = eval(lines[2].removeprefix("sample: "))  # noqa: S307 (a printed list of ints)
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)
