"""The rest of the BSP step's knobs end to end: PowerSGD with error
feedback, the plain ``qsgd`` twin on the int8 compressed wire with error
feedback, and ``adamw`` with the step's global-norm ``clip_norm``, each a
3-step loss series on the tiny workload against the reference's own
``build_bundle`` and ``Trainer`` (one worker, ``bucket_mb`` 4: one bucket),
within rtol 1e-4.

Both sides start from the reference's ``init_params(cfg, key(0), 1)``; the
port's noise hook replays the reference's key chain, and PowerSGD's Q is
the reference's ``key(1000 + i)`` draw.  The ``gpu`` tests run the same
paths at W = 2 on the card and count their kernel launches.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.compression import get_compressor as jget_compressor
from repro.core.types import CommConfig as JCommConfig
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant as jconstant
from repro.train.steps import build_bundle as jbuild_bundle
from repro.train.trainer import Trainer as JTrainer
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import BigramSource
from repro_torch.kernels import ops
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

#: (CommConfig fields, optimizer name, lr, clip_norm)
CELLS = {
    "powersgd-ef": (dict(compressor="powersgd", compressor_kwargs={"rank": 2},
                         error_feedback=True), "sgd", 0.05, 0.0),
    "qsgd-cwire-ef": (dict(compressor="qsgd", compressor_kwargs={"levels": 16},
                           wire_format="compressed", error_feedback=True), "sgd", 0.05, 0.0),
    # the tiny workload's gradient norm is above 0.5 on every step: the clip bites
    "adamw-clip": (dict(), "adamw", 1e-3, 0.5),
}
#: ... and, on the card only, ZeRO-1 over qsgd_kernel's fused EF
CARD_CELLS = {**CELLS, "zero1-qsgd-kernel": (
    dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, wire_format="compressed",
         error_feedback=True), "sgd", 0.05, 0.0)}
OPTS = {"sgd": lambda m: m.momentum_sgd(0.0), "adamw": lambda m: m.adamw()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    return torch.device("cuda")


class _Data:
    """The tiny workload's bigram stream (global batch 16, seq 64)."""

    def __init__(self, shape):
        self.shape, self.src = shape, BigramSource(128, seed=0)

    def batch(self, step):
        return self.src.batch(step, self.shape.global_batch, self.shape.seq_len)


def _jax_noise(step, worker, bucket, n):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.key(0), step), worker), bucket)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))


def _reference(cell):
    kw, name, lr, clip = CELLS[cell]
    cfg, shape, data = make_tiny_workload()
    bundle = jbuild_bundle(cfg, make_test_mesh(data=1, model=1),
                           JCommConfig(**kw, bucket_mb=4.0), OPTS[name](jopt), shape,
                           clip_norm=clip, seed=0, cache=False)
    tr = JTrainer(bundle, data, jconstant(lr), log_every=1)
    tr.fit(tr.init(), 3)
    return np.asarray([h["loss"] for h in tr.history]), bundle


def _port(cell, device="cpu", n_workers=1, optimizer=None, noise=_jax_noise, steps=3):
    kw, name, lr, clip = CARD_CELLS[cell]
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=128, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    shape = InputShape("train", 64, 16, "train")
    comm = CommConfig(**kw, bucket_mb=4.0)
    bundle = build_bundle(cfg, comm, optimizer or OPTS[name](opt), shape, n_workers=n_workers,
                          seed=0, device=device, noise=noise, clip_norm=clip)
    jcfg = make_tiny_workload()[0]
    params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jflatten(JT.init_params(jcfg, jax.random.key(0), 1))
         .items()}, cfg, device)
    state = bundle.init_state(params)
    if "psgd_q" in state["comm"]:  # the reference's key(1000 + i) draw
        jcomp = jget_compressor("powersgd", **kw["compressor_kwargs"])
        state["comm"]["psgd_q"] = [
            torch.from_numpy(np.array(jcomp.init_q(b.size, jax.random.key(1000 + i))))
            .reshape(-1).to(device) for i, b in enumerate(bundle.bucket_plan.buckets)]
    tr = Trainer(bundle, _Data(shape), constant(lr), log_every=1)
    tr.fit(state, steps)
    return np.asarray([h["loss"] for h in tr.history]), bundle


@pytest.mark.parametrize("cell", list(CELLS))
def test_knob_loss_series_matches_reference(cell):
    want, jbundle = _reference(cell)
    got, bundle = _port(cell)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(bundle.bucket_plan.buckets) == len(jbundle.bucket_plan.buckets) == 1
    assert got[-1] < got[0]


def test_powersgd_books_two_factor_psums_per_bucket():
    """At W = 2 a PowerSGD step books, per bucket, one f32 psum of P (a x r)
    and one of Q (b x r): (a + b) r 4 bytes times 2(W-1)/W in all."""
    from repro_torch.core.compression.powersgd import shape2d

    _, bundle = _port("powersgd-ef", n_workers=2, steps=1)
    want = sum(sum(shape2d(b.size)) * 2 * 4 for b in bundle.bucket_plan.buckets)
    assert bundle.wire["train"]["grad_agg"] == want * 2 * (2 - 1) / 2


@pytest.mark.gpu
@pytest.mark.parametrize("cell,optimizer,kernels", [
    ("qsgd-cwire-ef", None, {"int8_acc": 1}),  # plain codes, then the int8_acc reduce
    ("powersgd-ef", None, {}),  # matmuls and a QR: no port kernel
    # ZeRO-1 over qsgd_kernel's fused EF: one qsgd_ef per worker and bucket
    ("zero1-qsgd-kernel", "zero1", {"qsgd_ef": 2, "int8_acc": 1}),
])
def test_knob_paths_on_card_launch_their_kernels(cuda, cell, optimizer, kernels):
    """Each path at W = 2 on the card launches exactly its kernels, as many
    times as buckets (x workers) x steps call them; the losses stay close to
    the CPU plain path's (other sum orders in the model: rtol 1e-3)."""
    make = (lambda: opt.zero1(opt.momentum_sgd(0.9), 2)) if optimizer else (lambda: None)
    ops.reset_launches()
    on_card, bundle = _port(cell, device=cuda, n_workers=2, optimizer=make(),
                            noise=lambda *a: _jax_noise(*a).to(cuda))
    nb = len(bundle.bucket_plan.buckets)
    assert ops.LAUNCHES == {k: kernels.get(k, 0) * nb * 3 for k in ops.LAUNCHES}
    on_cpu, _ = _port(cell, n_workers=2, optimizer=make())
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)
    if optimizer:
        assert bundle.wire["train"]["zero1_gather"] > 0
