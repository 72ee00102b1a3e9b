"""The port's slices end to end: the BSP trainer step with QSGD over the
int8 compressed wire, with and without error feedback, with the 1-bit
sign compressors (``signsgd_packed`` with and without error feedback,
``signsgd``'s majority vote, on the compressed and the dense wire), with
``terngrad_kernel`` (with and without error feedback) and the ``terngrad``
twin (clipped at 2.5 sigma) on the 2-bit compressed wire, and with the
deterministic sparsifiers ``topk`` (sparse gather and scatter-add) and
``threshold`` (masked sum), each with error feedback, against the JAX
package's ``run_trainer_scenario`` on the tiny workload.

Both sides start from the reference's ``init_params(cfg, key(0), 1)`` (what
``Trainer.init()`` draws), use ``momentum_sgd(0.0)`` and ``constant(lr)``,
and the port's noise hook replays the reference's key chain
``fold_in(fold_in(fold_in(key(seed), step), worker), bucket)``, so the
3-step loss series must agree within rtol 1e-4.  ``data_par=1`` makes the
reference run one worker whatever ``n_workers`` says, so the port runs W=1.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.experiments import Scenario
from repro.experiments.trainer_substrate import make_tiny_workload, run_trainer_scenario
from repro.models import transformer as JT
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import BigramSource
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import momentum_sgd
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = dict(sync="bsp", n_workers=2, steps=3, lr=0.05, bucket_bytes=4e6)


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


def _jax_noise(seed):
    def noise(step, worker, bucket, n):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.key(seed), step), worker), bucket)
        return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))

    return noise


def _port_run(comm, device="cpu", noise=None, n_workers=1, steps=3):
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=128, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    shape = InputShape("train", 64, 16, "train")
    bundle = build_bundle(cfg, comm, momentum_sgd(0.0), shape, n_workers=n_workers, seed=0,
                          device=device, noise=noise)
    jcfg = make_tiny_workload()[0]
    jparams = JT.init_params(jcfg, jax.random.key(0), 1)
    params = interop.params_from_numpy({k: np.asarray(v) for k, v in jflatten(jparams).items()},
                                       cfg, device)
    tr = Trainer(bundle, _Data(shape), constant(0.05), log_every=1)
    tr.fit(bundle.init_state(params), steps)
    return bundle, np.asarray([h["loss"] for h in tr.history])


@pytest.mark.parametrize("error_feedback", [True, False])
def test_slice_loss_series_matches_reference(error_feedback):
    ref = run_trainer_scenario(
        Scenario(compressor="qsgd_kernel", compressor_kwargs=(("levels", 16),),
                 error_feedback=error_feedback, wire_format="compressed", **BASE),
        data_par=1)
    comm = CommConfig(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                      error_feedback=error_feedback, wire_format="compressed", bucket_mb=4.0)
    bundle, losses = _port_run(comm, noise=_jax_noise(0))
    assert len(bundle.bucket_plan.buckets) == 1
    np.testing.assert_allclose(losses, ref.series["loss_full"], rtol=1e-4)
    # one worker puts nothing on the wire; the reference books 0 KB too
    assert bundle.wire["train"]["grad_agg"] == 0.0 == ref.measured["wire_kb_per_step"]


SIGN_CELLS = {
    "packed-cwire-ef": dict(compressor="signsgd_packed", wire_format="compressed",
                            error_feedback=True),
    "packed-cwire": dict(compressor="signsgd_packed", wire_format="compressed"),
    "sign-cwire": dict(compressor="signsgd", wire_format="compressed"),
    "packed-dense": dict(compressor="signsgd_packed", wire_format="dense"),
}


@pytest.mark.parametrize("cell", list(SIGN_CELLS))
def test_sign_slice_loss_series_matches_reference(cell):
    kw = SIGN_CELLS[cell]
    ref = run_trainer_scenario(Scenario(**kw, **BASE), data_par=1)
    _, losses = _port_run(CommConfig(**kw, bucket_mb=4.0))
    np.testing.assert_allclose(losses, ref.series["loss_full"], rtol=1e-4)


TERN_LOSS_CELLS = {
    "kernel-ef": dict(compressor="terngrad_kernel", error_feedback=True),
    "kernel": dict(compressor="terngrad_kernel"),
    # the plain twin with clipping: its population std sums in another order
    # than XLA's, which moves codes only within an ulp of a dither boundary
    "twin-clip": dict(compressor="terngrad", compressor_kwargs={"clip_sigma": 2.5}),
}


@pytest.mark.parametrize("cell", list(TERN_LOSS_CELLS))
def test_tern_slice_loss_series_matches_reference(cell):
    kw = dict(TERN_LOSS_CELLS[cell], wire_format="compressed")
    skw = dict(kw, compressor_kwargs=tuple(sorted(kw.get("compressor_kwargs", {}).items())))
    ref = run_trainer_scenario(Scenario(**skw, **BASE), data_par=1)
    _, losses = _port_run(CommConfig(**kw, bucket_mb=4.0), noise=_jax_noise(0))
    np.testing.assert_allclose(losses, ref.series["loss_full"], rtol=1e-4)


SPARSE_LOSS_CELLS = {
    "topk-ef": dict(compressor="topk", compressor_kwargs={"ratio": 0.05}, error_feedback=True),
    "threshold-ef": dict(compressor="threshold", compressor_kwargs={"tau": 1e-3},
                         error_feedback=True),
}


@pytest.mark.parametrize("cell", list(SPARSE_LOSS_CELLS))
def test_sparse_slice_loss_series_matches_reference(cell):
    kw = SPARSE_LOSS_CELLS[cell]
    skw = dict(kw, compressor_kwargs=tuple(sorted(kw["compressor_kwargs"].items())))
    ref = run_trainer_scenario(Scenario(**skw, **BASE), data_par=1)
    bundle, losses = _port_run(CommConfig(**kw, bucket_mb=4.0))
    np.testing.assert_allclose(losses, ref.series["loss_full"], rtol=1e-4)
    assert losses[-1] < losses[0]


def test_sparse_slice_reports_the_kept_share():
    """At W=2 the threshold path books one f32 psum of each bucket's dense
    payload, and the step reports the share of elements it kept; top-k
    books its values and indices and reports none."""
    comm = CommConfig(compressor="threshold", compressor_kwargs={"tau": 1e-3},
                      error_feedback=True)
    bundle, losses = _port_run(comm, n_workers=2, steps=1)
    sizes = [b.size for b in bundle.bucket_plan.buckets]
    assert bundle.wire["train_formats"]["f32"] >= 4 * sum(sizes)
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=128, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    shape = InputShape("train", 64, 16, "train")
    tr = Trainer(build_bundle(cfg, comm, momentum_sgd(0.0), shape, n_workers=2, device="cpu"),
                 _Data(shape), constant(0.05), log_every=1)
    tr.fit(tr.init(seed=0), 2)
    assert all(0.0 < h["kept"] < 1.0 for h in tr.history)
    topk = CommConfig(compressor="topk", compressor_kwargs={"ratio": 0.05})
    bundle, losses = _port_run(topk, n_workers=2, steps=1)
    k = sum(max(1, int(n * 0.05)) for n in sizes)
    assert bundle.wire["train_formats"]["int32"] == 4 * k
    assert np.isfinite(losses).all()


def test_slice_books_int8_wire_per_worker():
    """At W=2 each step books the int8 codes and one f32 norm per bucket:
    all-gather p(n-1) with n = 2."""
    comm = CommConfig(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                      error_feedback=True, wire_format="compressed")
    bundle, losses = _port_run(comm, n_workers=2, steps=2)
    sizes = [b.size for b in bundle.bucket_plan.buckets]
    assert bundle.wire["train"]["grad_agg"] == sum(sizes) + 4 * len(sizes)
    assert bundle.wire["train_formats"]["int8"] == sum(sizes)
    assert np.isfinite(losses).all()


def test_slice_books_packed1_wire_per_worker():
    """At W=2 the compressed sign wire books one all-gather of each bucket's
    padded bitmap (ceil(n/8192)*1024 bytes) as packed1, and nothing else
    for the gradients (the f32 bytes are the loss metrics' mean)."""
    comm = CommConfig(compressor="signsgd_packed", error_feedback=True,
                      wire_format="compressed")
    bundle, losses = _port_run(comm, n_workers=2, steps=1)
    packed = sum(ops.sign_packed_bytes(b.size) for b in bundle.bucket_plan.buckets)
    assert bundle.wire["train"]["grad_agg"] == packed
    assert bundle.wire["train_formats"]["packed1"] == packed
    assert np.isfinite(losses).all()


def test_slice_books_packed2_wire_per_worker():
    """At W=2 the compressed ternary wire books one all-gather of each
    bucket's padded 2-bit payload (ceil(n/4096)*1024 bytes) as packed2 and
    one f32 scale per bucket."""
    comm = CommConfig(compressor="terngrad_kernel", error_feedback=True,
                      wire_format="compressed")
    bundle, losses = _port_run(comm, n_workers=2, steps=1)
    sizes = [b.size for b in bundle.bucket_plan.buckets]
    packed = sum(ops.tern_packed_bytes(n) for n in sizes)
    assert bundle.wire["train"]["grad_agg"] == packed + 4 * len(sizes)
    assert bundle.wire["train_formats"]["packed2"] == packed
    assert np.isfinite(losses).all()


def test_port_imports_neither_jax_nor_the_reference():
    """The port, chip_smoke.py and the card-only test modules (the model
    axis's among them)."""
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tests").glob("test_torch_*_card.py")))
    assert len(files) > 15
    assert ROOT / "tests" / "test_torch_model_axis_card.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {m}"


@pytest.mark.gpu
def test_slice_on_card_launches_every_kernel(cuda):
    """Both paths of the slice on the card, through the hand-written
    kernels; the losses stay close to the CPU plain path's (other sum orders,
    so rtol 1e-3)."""
    for ef, kernels in ((True, ("qsgd_ef", "int8_acc")), (False, ("qsgd", "int8_acc"))):
        comm = CommConfig(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                          error_feedback=ef, wire_format="compressed", bucket_mb=4.0)
        ops.reset_launches()
        _, on_card = _port_run(comm, device=cuda, noise=lambda *a: _jax_noise(0)(*a).to(cuda))
        for k in kernels:
            assert ops.LAUNCHES[k] == 3, (k, ops.LAUNCHES)
        _, on_cpu = _port_run(comm, noise=_jax_noise(0))
        np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("cell,kernels", [
    ("packed-cwire-ef", ("sign_pack", "sign_vote")),
    ("sign-cwire", ("sign_pack", "sign_vote")),
    ("packed-dense", ("sign_pack", "sign_unpack")),
])
def test_sign_slice_on_card_launches_every_kernel(cuda, cell, kernels):
    """The sign paths on the card at W=2 (so the wire carries two rows),
    through the hand-written kernels; the losses stay close to the CPU plain
    path's (other sum orders in the model, so rtol 1e-3)."""
    comm = CommConfig(**SIGN_CELLS[cell], bucket_mb=4.0)
    ops.reset_launches()
    _, on_card = _port_run(comm, device=cuda, n_workers=2)
    for k in kernels:
        assert ops.LAUNCHES[k] > 0, (k, ops.LAUNCHES)
    _, on_cpu = _port_run(comm, n_workers=2)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)


TERN_CELLS = {
    "tern-cwire-ef": dict(compressor="terngrad_kernel", wire_format="compressed",
                          error_feedback=True),
    "terngrad-cwire-clip": dict(compressor="terngrad", compressor_kwargs={"clip_sigma": 2.5},
                                wire_format="compressed"),
    "tern-dense": dict(compressor="terngrad_kernel", wire_format="dense"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell,kernels,absent", [
    ("tern-cwire-ef", ("terngrad", "tern_pack", "tern_acc"), ()),
    ("terngrad-cwire-clip", ("tern_pack", "tern_acc"), ("terngrad",)),  # a plain twin
    ("tern-dense", ("terngrad",), ("tern_pack", "tern_acc")),
])
def test_tern_slice_on_card_launches_every_kernel(cuda, cell, kernels, absent):
    """The ternary paths on the card at W=2, through the hand-written
    kernels, with the reference's noise on both sides; the losses stay close
    to the CPU plain path's (other sum orders in the model, so rtol 1e-3)."""
    comm = CommConfig(**TERN_CELLS[cell], bucket_mb=4.0)
    ops.reset_launches()
    _, on_card = _port_run(comm, device=cuda, noise=lambda *a: _jax_noise(0)(*a).to(cuda),
                           n_workers=2)
    for k in kernels:
        assert ops.LAUNCHES[k] > 0, (k, ops.LAUNCHES)
    for k in absent:
        assert ops.LAUNCHES[k] == 0, (k, ops.LAUNCHES)
    _, on_cpu = _port_run(comm, noise=_jax_noise(0), n_workers=2)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(SPARSE_LOSS_CELLS))
def test_sparse_slice_on_card(cuda, cell):
    """The sparsifier paths on the card at W=2: threshold through its kernel,
    once per worker, bucket and step; top-k through no port kernel (a stable
    sort).  The losses stay close to the CPU plain path's (other sum orders
    in the model, so rtol 1e-3)."""
    comm = CommConfig(**SPARSE_LOSS_CELLS[cell], bucket_mb=4.0)
    ops.reset_launches()
    bundle, on_card = _port_run(comm, device=cuda, n_workers=2)
    calls = len(bundle.bucket_plan.buckets) * 2 * 3 if cell == "threshold-ef" else 0
    assert ops.LAUNCHES == {k: (calls if k == "threshold" else 0) for k in ops.LAUNCHES}
    _, on_cpu = _port_run(comm, n_workers=2)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)
