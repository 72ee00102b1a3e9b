"""The MoE and sliding-window layers, and one MoE trainer step, on the card
against the port's own CPU result (f32, TF32 off).  Every test here is
``gpu``-marked and skips off the card; the module imports no jax, so it
runs on a machine with the port alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_families_card.py

* ``moe_ffn`` of the reduced qwen3-moe and deepseek-v2-lite layers at
  capacity factor 1.25 and 0.5 (drops): outputs and ``aux`` within rtol
  1e-4 / atol 1e-5 x max|y| (other sum orders in the products);
* gemma3's windowed ``attention`` (reduced: window 16 at seq 64) at query
  chunks 64 and 16 (the sliced KV block): rtol 1e-4 / atol 1e-5 x max|o|;
* one step of the reduced qwen3-moe at W = 2 under ``qsgd_kernel`` EF on
  the int8 compressed wire: exactly ``qsgd_ef`` once per worker and bucket
  and ``int8_acc`` once per bucket, the loss within rtol 1e-4 of the CPU's.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import BigramSource
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _close(got, want, rtol):
    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_on_card_matches_cpu(cuda, arch, cf):
    cfg = get_config(arch).reduced()
    p = T.init_params(cfg, seed=0, device="cpu")["blocks"][0]["0"]["moe"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, cfg.d_model))
                         .astype(np.float32))
    want_y, want_aux = L.moe_ffn(cfg, p, x, capacity_factor=cf)
    on_card = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else
                   {kk: vv.to(cuda) for kk, vv in v.items()}) for k, v in p.items()}
    y, aux = L.moe_ffn(cfg, on_card, x.to(cuda), capacity_factor=cf)
    _close(y, want_y, 1e-4)
    _close(aux, want_aux, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("q_chunk", [64, 16])
def test_windowed_attention_on_card_matches_cpu(cuda, q_chunk):
    cfg = get_config("gemma3-12b").reduced()
    assert cfg.attn_pattern[0] == "local" and cfg.window == 16
    p = T.init_params(cfg, seed=0, device="cpu")["blocks"][0]["0"]["attn"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 64, cfg.d_model))
                         .astype(np.float32))
    pos = T.make_positions(cfg, 2, 64, "cpu")
    want = L.attention(cfg, p, x, positions=pos, window=16, q_chunk=q_chunk)
    got = L.attention(cfg, {k: v.to(cuda) for k, v in p.items()}, x.to(cuda),
                      positions=pos.to(cuda), window=16, q_chunk=q_chunk)
    _close(got, want, 1e-4)


class _Data:
    def __init__(self, vocab, shape):
        self.src, self.shape = BigramSource(vocab, seed=0), shape

    def batch(self, step):
        return self.src.batch(step, self.shape.global_batch, self.shape.seq_len)


def _moe_step(device):
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    shape = InputShape("train", 32, 4, "train")
    comm = CommConfig(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                      wire_format="compressed", error_feedback=True)
    bundle = build_bundle(cfg, comm, opt.momentum_sgd(0.0), shape, n_workers=2, seed=0,
                          device=device)
    tr = Trainer(bundle, _Data(cfg.vocab, shape), constant(0.05), log_every=1)
    tr.fit(bundle.init_state(T.init_params(cfg, seed=0, device="cpu")), 1)
    return tr.history[-1], len(bundle.bucket_plan.buckets)


@pytest.mark.gpu
def test_moe_trainer_step_on_card_launches_its_kernels(cuda):
    ops.reset_launches()
    on_card, nb = _moe_step(cuda)
    assert ops.LAUNCHES == {k: {"qsgd_ef": 2 * nb, "int8_acc": nb}.get(k, 0)
                            for k in ops.LAUNCHES}
    on_cpu, _ = _moe_step("cpu")
    assert on_card["aux"] > 0
    np.testing.assert_allclose(on_card["loss"], on_cpu["loss"], rtol=1e-4)
