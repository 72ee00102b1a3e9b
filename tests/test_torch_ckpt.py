"""Checkpoints in the port (``repro_torch.checkpoint``, ``Trainer.save`` /
``restore`` / ``restore_rejoin``, ``ckpt_every``, the launchers'
``--ckpt-dir`` and ``--restore``), against the JAX package's format.

* A port round trip is bitwise, leaf by leaf, and the next step after it
  equals the uninterrupted run's: BSP with ``qsgd_kernel`` error feedback
  and momentum, local SGD (stacked parameters and optimizer state), CHOCO
  (its mirrors), PowerSGD (its Q) and bf16 parameters with ``adamw``.
* A BSP checkpoint crosses the packages in both directions: written by one,
  restored by the other into its own state, parameters, optimizer state and
  comm state equal, and the next step's loss within rtol 1e-4 of the
  writer's own.
* ``restore_rejoin`` pulls parameters, optimizer state and step, and starts
  the comm state fresh (zero residuals), as the reference's does; the step
  after it matches the reference's ``restore_rejoin`` on the same file.
* ``launch/train.py --device cpu --reduced`` writes checkpoints with
  ``--ckpt-dir`` and resumes from one with ``--restore``, bitwise; its
  unported options raise.  ``launch/serve.py --restore`` serves a
  checkpoint's parameters.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.core.types import CommConfig as JCommConfig
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.launch.mesh import make_test_mesh
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant as jconstant
from repro.train.steps import build_bundle as jbuild_bundle
from repro.train.trainer import Trainer as JTrainer
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.core.types import CommConfig
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import init_params
from repro_torch.optim import optimizers as opt
from repro_torch.utils.tree import flatten_with_paths
from test_torch_sync import _noise, _one_thread, port_run  # noqa: F401

Q = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16})
BSP_EF = dict(error_feedback=True, wire_format="compressed", bucket_mb=4.0, **Q)


@pytest.fixture
def deterministic():
    """Deterministic kernels for a bitwise comparison of two runs: torch's
    CPU embedding backward accumulates repeated tokens in a thread-dependent
    order, so two runs from the same state differ in the last bit of some
    gradients (the checkpoint itself is bitwise either way)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _flat(tree):
    """{path: numpy array or int} of a state, None leaves dropped."""
    out = {}
    for k, v in flatten_with_paths(tree).items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().to(torch.float32).numpy() if v.dtype == torch.bfloat16 \
                else v.detach().numpy()
        elif v is not None:
            out[k] = v
    return out


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


ROUND_TRIP = {
    "bsp-qsgd-ef-momentum": (BSP_EF, 2, "momentum", None),
    "local-sgd": (dict(sync="local", local_steps=2, bucket_mb=4.0), 2, "momentum", None),
    "choco-signsgd_packed": (dict(aggregator="gossip", gossip_compress="choco",
                                  compressor="signsgd_packed"), 2, "momentum", None),
    "powersgd-ef": (dict(compressor="powersgd", compressor_kwargs={"rank": 2},
                         error_feedback=True), 2, "momentum", None),
    "bf16-adamw": (dict(), 1, "adamw", "bfloat16"),
}
OPTS = {"momentum": lambda: opt.momentum_sgd(0.9), "adamw": opt.adamw}


@pytest.mark.parametrize("cell", list(ROUND_TRIP))
def test_port_round_trip_is_bitwise(cell, tmp_path, deterministic):
    kw, n_workers, name, dtype = ROUND_TRIP[cell]
    comm = CommConfig(**kw)
    bundle, tr, state, _ = port_run(comm, n_workers=n_workers, steps=2, lr=0.01,
                                    optimizer=OPTS[name](),
                                    cfg_updates=dtype and {"param_dtype": dtype,
                                                           "compute_dtype": dtype})
    tr.save(str(tmp_path / "ck"), state, 2)
    with open(tmp_path / "ck" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 2 and manifest["keys"] == sorted(manifest["keys"])
    back, step = tr.restore(str(tmp_path / "ck"))
    assert step == 2
    _assert_states_equal(back, state)
    if dtype:
        assert back["params"]["embed"]["embedding"].dtype == torch.bfloat16
    # the next step from the restored state equals the uninterrupted one
    n = len(tr.history)
    state = tr.fit(state, 1, start_step=2)
    back = tr.fit(back, 1, start_step=2)
    assert tr.history[n]["loss"] == tr.history[n + 1]["loss"]
    _assert_states_equal(back, state)


def test_ckpt_every_then_resume_matches_the_uninterrupted_run(tmp_path, deterministic):
    comm = CommConfig(sync="post_local", post_local_switch=1, local_steps=2, **BSP_EF)
    bundle, tr, state, _ = port_run(comm, n_workers=2, steps=0)
    tr.ckpt_dir, tr.ckpt_every = str(tmp_path), 2
    full = tr.fit(state, 4)
    assert sorted(os.listdir(tmp_path)) == ["step2", "step4"]
    resumed, step = tr.restore(str(tmp_path / "step2"))
    assert step == 2 and resumed["step"] == 2
    tr.ckpt_dir = None
    _assert_states_equal(tr.fit(resumed, 2, start_step=2), full)


def _reference_trainer(comm_kw, optimizer):
    cfg, shape, data = make_tiny_workload()
    jb = jbuild_bundle(cfg, make_test_mesh(data=1, model=1), JCommConfig(**comm_kw), optimizer,
                       shape, seed=0, cache=False)
    return JTrainer(jb, data, jconstant(0.01), log_every=1)


def _jflat(tree):
    return {k: np.asarray(jnp.asarray(v, jnp.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in jflatten(tree).items()}


def test_bsp_checkpoint_crosses_the_packages(tmp_path):
    """qsgd_kernel EF on the int8 wire with momentum 0.9 at W = 1: a
    checkpoint written by either package after 2 steps restores in the
    other; every leaf equal, the next step's loss within rtol 1e-4."""
    # port -> reference
    bundle, tr, state, _ = port_run(CommConfig(**BSP_EF), n_workers=1, steps=2, lr=0.01,
                                    optimizer=opt.momentum_sgd(0.9))
    tr.save(str(tmp_path / "port"), state, 2)
    jt = _reference_trainer(BSP_EF, jopt.momentum_sgd(0.9))
    jstate, step = jrestore(str(tmp_path / "port"), jt.init())
    assert step == 2
    port_flat = _flat(bundle.checkpoint_tree(state))
    ref_flat = _jflat(jstate)
    assert port_flat.keys() == ref_flat.keys()
    for k in port_flat:
        np.testing.assert_array_equal(np.asarray(port_flat[k]), ref_flat[k], err_msg=k)
    jt.fit(jstate, 1, start_step=2)
    tr.fit(state, 1, start_step=2)
    assert jt.history[-1]["loss"] == pytest.approx(tr.history[-1]["loss"], rel=1e-4)

    # reference -> port
    jt = _reference_trainer(BSP_EF, jopt.momentum_sgd(0.9))
    jstate = jt.fit(jt.init(), 2)
    jsave(str(tmp_path / "ref"), jstate, step=2)
    back, step = tr.restore(str(tmp_path / "ref"))
    assert step == 2 and back["step"] == 2 and back["comm"]["step"] == 2
    port_flat, ref_flat = _flat(bundle.checkpoint_tree(back)), _jflat(jstate)
    assert port_flat.keys() == ref_flat.keys()
    for k in port_flat:
        np.testing.assert_array_equal(np.asarray(port_flat[k]), ref_flat[k], err_msg=k)
    n = len(tr.history)
    tr.fit(back, 1, start_step=2)
    jt.fit(jstate, 1, start_step=2)
    assert tr.history[n]["loss"] == pytest.approx(jt.history[-1]["loss"], rel=1e-4)


def test_restore_rejoin_starts_comm_state_fresh(tmp_path):
    """On the reference's own checkpoint: parameters, optimizer state and
    step restored, the EF residual zero and the comm step the restored
    one, as the reference's ``restore_rejoin`` gives; the next step's loss
    matches the reference's after its own ``restore_rejoin``."""
    jt = _reference_trainer(BSP_EF, jopt.momentum_sgd(0.9))
    jstate = jt.fit(jt.init(), 2)
    jsave(str(tmp_path / "ck"), jstate, step=2)
    bundle, tr, _, _ = port_run(CommConfig(**BSP_EF), n_workers=1, steps=0, lr=0.01,
                                optimizer=opt.momentum_sgd(0.9))
    state, step = tr.restore_rejoin(str(tmp_path / "ck"))
    assert step == 2 == state["step"] == state["comm"]["step"]
    assert not any(bool(e.any()) for e in state["comm"]["ef"])
    ref_flat = _jflat(jstate)
    for k, v in _flat({"params": state["params"]}).items():
        np.testing.assert_array_equal(v, ref_flat[k], err_msg=k)
    jstate2, jstep = jt.restore_rejoin(str(tmp_path / "ck"))
    assert jstep == 2 and not any(np.asarray(e).any() for e in jstate2["comm"]["ef"])
    tr.fit(state, 1, start_step=2)
    jt.fit(jstate2, 1, start_step=2)
    assert tr.history[-1]["loss"] == pytest.approx(jt.history[-1]["loss"], rel=1e-4)


def test_restore_names_both_sides_of_a_key_mismatch(tmp_path):
    save(str(tmp_path / "ck"), {"params": {f"w{i}": torch.zeros(2) for i in range(3)},
                                "step": 3}, step=3)
    with pytest.raises(ValueError) as e:
        restore(str(tmp_path / "ck"), {"params": {"w0": torch.zeros(2)},
                                       "opt": {"mu": torch.zeros(2)}, "step": 0})
    msg = str(e.value)
    assert "2 checkpoint key(s) absent from the restore tree" in msg and "w2" in msg
    assert "1 restore-tree key(s) absent from the checkpoint" in msg and "mu" in msg
    out, step = restore(str(tmp_path / "ck"), {"params": {"w1": torch.zeros(2)}, "step": 0},
                        partial=True)
    assert step == 3 and out["step"] == 3
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path / "ck"), {"params": {"w1": torch.zeros(3)}}, partial=True)
    assert sorted(os.listdir(tmp_path / "ck")) == ["arrays.npz", "manifest.json"]


# ---------------------------------------------------------------------------
# The launchers.
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--workers", "2",
              "--comm", "local_sgd", "--local-steps", "2", "--steps", "4", "--seq-len", "16",
              "--global-batch", "4", "--warmup", "1", "--ckpt-every", "2"]


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys, deterministic):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert launch_train.main(TRAIN_ARGS + ["--ckpt-dir", a]) == 0
    assert sorted(os.listdir(a)) == ["step2", "step4"]
    assert launch_train.main(TRAIN_ARGS + ["--ckpt-dir", b, "--restore",
                                           os.path.join(a, "step2")]) == 0
    out = capsys.readouterr().out
    assert "restored step 2 from" in out and "step     5 loss" in out
    with np.load(os.path.join(a, "step4", "arrays.npz")) as za, \
            np.load(os.path.join(b, "step4", "arrays.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert za["params/embed/embedding"].shape[0] == 2  # one row per worker
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("extra", [["--pod", "2"], ["--pod-local"], ["--overlap", "pipelined"],
                                   ["--comm", "pod_local_sgd"]], ids=" ".join)
def test_train_launcher_runs_pod_and_pipelined_layouts(extra, capsys):
    """The two-level layout, pod-local SGD (the flag and the preset) and
    pipelined overlap run; pipelined overlap under local SGD is the
    reference's ValueError."""
    args = TRAIN_ARGS[:5] + ["--steps", "1", "--seq-len", "16", "--global-batch", "4"] + extra
    assert launch_train.main(args) == 0
    assert "step     0 loss" in capsys.readouterr().out
    if extra == ["--overlap", "pipelined"]:
        with pytest.raises(ValueError, match="sync must be bsp"):
            launch_train.main(args + ["--comm", "local_sgd"])


def test_serve_launcher_restores_checkpoint_params(tmp_path, capsys):
    cfg = get_config("rwkv6-3b").reduced()
    saved = init_params(cfg, 1, "cpu")
    save(str(tmp_path / "ck"), {"params": saved, "step": 7}, step=7)
    res = serve.run(cfg, prompt_len=8, batch=2, decode=2, device="cpu", seed=0,
                    restore=str(tmp_path / "ck"))
    for k, v in flatten_with_paths(saved).items():
        assert torch.equal(flatten_with_paths(res["params"])[k], v), k
    assert res["tokens"].shape == (2, 2)
    assert serve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu", "--prompt-len",
                       "8", "--batch", "2", "--decode", "2",
                       "--restore", str(tmp_path / "ck")]) == 0
    assert f"restored params from {tmp_path / 'ck'}" in capsys.readouterr().out


def test_noise_hook_is_the_reference_chain():
    """The shared hook of these tests draws what the reference's trainer
    draws: a per-worker key for the aggregation, none for CHOCO's round."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), 3), 1)
    np.testing.assert_array_equal(
        _noise(3, 1, 2, 5).numpy(), np.asarray(jax.random.uniform(jax.random.fold_in(key, 2),
                                                                   (5,))))
    key = jax.random.fold_in(jax.random.key(0), 3)
    np.testing.assert_array_equal(
        _noise(3, None, 2, 5).numpy(),
        np.asarray(jax.random.uniform(jax.random.fold_in(key, 2), (5,))))
