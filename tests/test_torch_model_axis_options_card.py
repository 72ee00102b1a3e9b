"""The training options of slice 21 on the model axis, on the card
(gpu-marked; imports no jax and nothing of the reference): chip_smoke.py's
paths (bm)-(bp) at the tiny size, data 4 x model 2 (qwen3-0.6b reduced,
vocab 128 padded to 256), 3 steps each:

* (bm) qsgd_kernel EF on the int8 wire under 25% dropout and 25% ``"nan"``
  corruption, ``quarantine_limit`` 2;
* (bn) pod-local SGD on 2 pods x 2, H 2, qsgd_kernel EF, ZeRO-1 over the
  pods' rows under 25% dropout: the rows equal after every step;
* (bo) the pipelined step at staleness 1, microbatch 2, terngrad_kernel EF
  under 25% dropout (the rounds on the side stream);
* (bp) PowerSGD rank 4 with EF: no port kernel.

Each launches exactly its kernels (W x M per shard-local bucket on the
send side, M, or M x the pods, on the receive side, x the rounds of a
step: a dead worker's codes still go through the reduction at weight 0),
and its losses agree with the same run on the CPU (the same weights and
draws) within rtol 1e-3.  And (bm) at dropout 0 and corruption 0 equals
its churn-free twin bitwise under deterministic algorithms."""

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
from repro_torch.utils.tree import leaves, tree_map
from test_torch_model_axis_card import _noise, cuda  # noqa: F401

W, M, PODS = 4, 2, 2
Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, error_feedback=True,
            wire_format="compressed")
TERN_EF = dict(compressor="terngrad_kernel", error_feedback=True, wire_format="compressed")
#: name -> (CommConfig fields, build options, {kernel: launches per bucket and step})
CELLS = {
    "bm": (dict(**Q_EF, dropout_rate=0.25, corruption_kind="nan", corruption_rate=0.25,
                quarantine_limit=2), {}, {"qsgd_ef": W * M, "int8_acc": M}),
    "bn": (dict(pod_local=True, local_steps=2, **Q_EF, dropout_rate=0.25),
           {"pods": PODS, "zero1": True}, {"qsgd_ef": W * M, "int8_acc": PODS * M}),
    "bo": (dict(overlap="pipelined", overlap_staleness=1, **TERN_EF, dropout_rate=0.25),
           {"microbatch": 2},
           {"terngrad": 2 * W * M, "tern_pack": 2 * W * M, "tern_acc": 2 * M}),
    "bp": (dict(compressor="powersgd", compressor_kwargs={"rank": 4}, error_feedback=True), {},
           {}),
}


def _churn_draws(step, worker, rnd=None):
    """Two uniforms per (step, worker, round) from a CPU generator, the same
    on either device."""
    g = torch.Generator().manual_seed(hash((7, step, worker, rnd)) & 0x7FFFFFFF)
    u = torch.rand(2, generator=g)
    return u[0], u[1]


def _run(comm, build, device, steps=3):
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=128, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    shape = InputShape("train", 16, 8, "train")
    src = BigramSource(cfg.vocab, seed=0)

    class Data:
        def batch(self, step):
            return src.batch(step, shape.global_batch, shape.seq_len)

    o = opt.momentum_sgd(0.9)
    if build.get("zero1"):
        o = opt.zero1(o, W)
    b = build_bundle(cfg, comm, o, shape, n_workers=W, device=device, noise=_noise,
                     churn_draws=_churn_draws, model=M, pods=build.get("pods", 1),
                     microbatch=build.get("microbatch", 1), cache=False)
    tr = Trainer(b, Data(), constant(0.05), log_every=1)
    state = b.init_state(tree_map(lambda p: p.to(device), T.init_params(cfg, 0, "cpu", M)))
    ops.reset_launches()
    rows_equal = []
    for t in range(steps):
        state = tr.fit(state, 1, start_step=t)
        if b.stacked:
            rows_equal.append(all(torch.equal(p[0], p[r]) for p in leaves(state["params"])
                                  for r in range(p.shape[0])))
    return b, [h["loss"] for h in tr.history], dict(ops.LAUNCHES), state, rows_equal


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CELLS))
def test_model_axis_option_on_card(cuda, cell):
    kw, build, per_bucket = CELLS[cell]
    comm = CommConfig(bucket_mb=0.25, **kw)
    b, on_card, launches, state, rows_equal = _run(comm, build, cuda)
    nb = len(b.bucket_plan.buckets)
    assert nb > 1
    assert {k: v for k, v in launches.items() if v} == {k: n * nb * 3
                                                        for k, n in per_bucket.items()}
    if build.get("zero1"):
        assert rows_equal == [True] * 3
    if "dropout_rate" in kw:
        assert state["comm"]["alive_prev"].shape == (W * M,)
    _, on_cpu, _, _, _ = _run(comm, build, "cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)


@pytest.mark.gpu
def test_model_axis_churn0_is_its_twin_on_card(cuda):
    kw = CELLS["bm"][0]
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = [_run(CommConfig(bucket_mb=0.25, **c), {}, cuda)
               for c in (Q_EF, dict(kw, churn=True, dropout_rate=0.0, corruption_rate=0.0))]
    finally:
        torch.use_deterministic_algorithms(det)
    (_, lt, kt, st, _), (_, lc, kc, sc, _) = out
    assert lt == lc and kt == kc
    for a, c in zip(leaves(st["params"]), leaves(sc["params"])):
        assert torch.equal(a, c)
