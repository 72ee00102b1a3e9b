"""The model axis on the card (gpu-marked; imports no jax and nothing of
the reference).

* A model-2 trainer step on the card: the tiny workload (qwen3-0.6b
  reduced, vocab 128 padded to 256) at W = 2 workers x M = 2 shards, 3
  steps of qsgd_kernel on the int8 wire with error feedback, then 3 of
  terngrad_kernel with error feedback: each kernel launched exactly W x M
  times per shard-local bucket on the send side and M times on the receive
  side, a step; the losses within rtol 1e-3 of the same run on the CPU
  (the same weights and draws; other sum orders).
* The TP identity on the card, f32 with TF32 off: qwen3-0.6b and
  deepseek-v2-lite-16b reduced, and rwkv6-3b reduced through kernels wkv6
  and wkv6_bwd; the objective at model-axis size 2 within 2e-4 relative of
  size 1's, the squared gradient norm within 5e-3 relative.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import BigramSource
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import leaves, tree_map, unflatten_like

W, M = 2, 2
CELLS = {
    "qsgd_kernel_ef": (dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                            error_feedback=True, wire_format="compressed"),
                       {"qsgd_ef": W, "int8_acc": 1}),
    "terngrad_kernel_ef": (dict(compressor="terngrad_kernel", error_feedback=True,
                                wire_format="compressed"),
                           {"terngrad": W, "tern_pack": W, "tern_acc": 1}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _noise(step, worker, bucket, n, rnd=None):
    g = torch.Generator().manual_seed(hash((step, worker, bucket, rnd)) & 0x7FFFFFFF)
    return torch.rand(n, generator=g)


def _run(comm, device):
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=128, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    shape = InputShape("train", 16, 8, "train")
    src = BigramSource(cfg.vocab, seed=0)

    class Data:
        def batch(self, step):
            return src.batch(step, shape.global_batch, shape.seq_len)

    b = build_bundle(cfg, comm, opt.momentum_sgd(0.9), shape, n_workers=W, device=device,
                     noise=_noise, model=M, cache=False)
    tr = Trainer(b, Data(), constant(0.05), log_every=1)
    params = tree_map(lambda p: p.to(device), T.init_params(cfg, 0, "cpu", M))
    ops.reset_launches()
    tr.fit(b.init_state(params), 3)
    return b, [h["loss"] for h in tr.history], dict(ops.LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CELLS))
def test_model_axis_step_on_card(cuda, cell):
    kw, per_bucket = CELLS[cell]
    comm = CommConfig(bucket_mb=0.25, **kw)
    b, on_card, launches = _run(comm, cuda)
    nb = len(b.bucket_plan.buckets)
    assert nb > 1
    for k, n in per_bucket.items():
        assert launches[k] == n * M * nb * 3, (k, launches)
    assert sum(launches.values()) == sum(n * M * nb * 3 for n in per_bucket.values())
    _, on_cpu, _ = _run(comm, "cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-lite-16b", "rwkv6-3b"])
def test_tp_identity_on_card(cuda, arch):
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, 0, cuda, 2)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=g).to(cuda)
             for k in ("tokens", "labels")}
    got = []
    for m in (2, 1):
        ps = [p.detach().clone().requires_grad_(True) for p in leaves(params)]
        ops.reset_launches()
        loss, met = T.forward_loss(cfg, unflatten_like(params, ps), batch, msize=m)
        g2 = sum(float(torch.sum(torch.square(x.double())))
                 for x in torch.autograd.grad(loss, ps))
        got.append((float((met["ce"] + cfg.router_aux_coef * met["aux"]).detach()), g2,
                    dict(ops.LAUNCHES)))
    (l2, g2, k2), (l1, g1, _) = got
    assert abs(l2 - l1) < 2e-4 * max(1.0, abs(l1)), (l2, l1)
    assert abs(g2 - g1) < 5e-3 * max(1.0, abs(g1)), (g2, g1)
    if cfg.family == "ssm":
        assert k2["wkv6"] > 0 and k2["wkv6_bwd"] > 0, k2
