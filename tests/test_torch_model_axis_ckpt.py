"""Checkpoints, the trainer substrate and the launcher on the model axis.

* As tests/test_trainer_ckpt.py does for the reference: a run at data 4 x
  model 2 (top-k 10% with error feedback; qwen3-0.6b reduced to 2 layers,
  d 128, vocab 64 padded to 256) is saved after 3 steps and restored at
  pod 2 x data 2 x model 2; its next 2 steps equal the uninterrupted run's
  (rtol 1e-6: the same arithmetic).  The reference's own checkpoint of the
  same run at 4 x 2 restores into the port, whose next 2 steps equal the
  reference's within rtol 1e-4; the port's checkpoint at the same step
  holds the reference's keys and shapes.
* ``run_trainer_scenario(model_par=2)`` and ``run_trainer_sweep(...,
  model_par=2)`` at data 4 against the reference's (one qsgd_kernel EF cell
  with its key chain replayed): the loss series within rtol 1e-4, the wire
  per step and by format equal.
* ``launch/train.py --model 2 --device cpu`` runs.
One 8-device subprocess runs the reference for the module."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import BigramSource
from repro_torch.experiments import Scenario
from repro_torch.experiments import trainer_substrate as P
from repro_torch.launch import train as launch_train
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from test_torch_sync import _noise, _one_thread  # noqa: F401

CELL = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, error_feedback=True,
            wire_format="compressed")

REFERENCE = r"""
import json, sys
import jax, numpy as np
from repro.checkpoint import save
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core.types import CommConfig
from repro.data.pipeline import BigramSource
from repro.experiments import Scenario
from repro.experiments.trainer_substrate import make_tiny_workload, run_trainer_scenario
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.optim.optimizers import momentum_sgd
from repro.optim.schedules import constant
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
from repro.utils.tree import flatten_with_paths
OUT, CELL = sys.argv[1], json.loads(sys.argv[2])
cfg = get_config("qwen3-0.6b").reduced().with_updates(
    vocab=64, n_layers=2, d_ff=128, d_model=128, head_dim=32)
shape = InputShape("t", 32, 8, "train")
src = BigramSource(cfg.vocab, seed=3)
class Data:
    def batch(self, step): return src.batch(step, shape.global_batch, shape.seq_len)
comm = CommConfig(compressor="topk", compressor_kwargs={"ratio": 0.1}, error_feedback=True)
b = build_bundle(cfg, make_test_mesh(data=4, model=2), comm, momentum_sgd(0.0), shape)
t = Trainer(b, Data(), constant(0.1), log_every=1)
state = t.fit(t.init(0), 3)
np.savez(OUT + "/p0.npz", **{k: np.asarray(v, np.float32) for k, v in
                            flatten_with_paths(JT.init_params(cfg, jax.random.key(0), 2)).items()})
save(OUT + "/ref_ck", state, step=3)
t.fit(state, 2, start_step=3)
out = {"ckpt": [h["loss"] for h in t.history]}
tcfg = make_tiny_workload()[0]
tparams = JT.init_params(tcfg, jax.random.key(0), 2)
np.savez(OUT + "/tiny.npz",
         **{k: np.asarray(v, np.float32) for k, v in flatten_with_paths(tparams).items()})
r = run_trainer_scenario(Scenario(n_workers=4, steps=3, bucket_bytes=4e6, lr=0.05, **CELL),
                         data_par=4, model_par=2)
out["scenario"] = {"loss": [float(x) for x in r.series["loss_full"]],
                   "wire_kb": r.measured["wire_kb_per_step"],
                   "formats": r.measured["wire_format_kb"]}
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("model_axis_ckpt")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(out), json.dumps(CELL)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return out, json.loads(run.stdout.split("REF ", 1)[1])


def _ckpt_setup():
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=64, n_layers=2, d_ff=128, d_model=128, head_dim=32)
    shape = InputShape("t", 32, 8, "train")
    src = BigramSource(cfg.vocab, seed=3)

    class Data:
        def batch(self, step):
            return src.batch(step, shape.global_batch, shape.seq_len)

    comm = CommConfig(compressor="topk", compressor_kwargs={"ratio": 0.1}, error_feedback=True)

    def make(workers, pods):
        b = build_bundle(cfg, comm, opt.momentum_sgd(0.0), shape, n_workers=workers,
                         pods=pods, model=2, device="cpu", cache=False)
        return b, Trainer(b, Data(), constant(0.1), log_every=1)

    return cfg, make


def test_checkpoint_restores_across_meshes(reference, tmp_path):
    out, ref = reference
    cfg, make = _ckpt_setup()
    b1, t1 = make(4, 1)
    p0 = interop.params_from_numpy(dict(np.load(out / "p0.npz")), cfg, "cpu", 2)
    state = t1.fit(b1.init_state(p0), 3)
    t1.save(str(tmp_path / "ck"), state, 3)
    t1.fit(state, 2, start_step=3)
    uninterrupted = [h["loss"] for h in t1.history]
    np.testing.assert_allclose(uninterrupted, ref["ckpt"], rtol=1e-4)

    # the port's checkpoint holds the reference's keys and shapes
    with np.load(out / "ref_ck" / "arrays.npz") as z:
        want = {k: z[k].shape for k in z.files}
    with np.load(tmp_path / "ck" / "arrays.npz") as z:
        got = {k: z[k].shape for k in z.files}
    assert got == want

    b2, t2 = make(4, 2)  # pod 2 x data 2 x model 2
    state2, step = t2.restore(str(tmp_path / "ck"))
    assert step == 3
    t2.fit(state2, 2, start_step=3)
    np.testing.assert_allclose([h["loss"] for h in t2.history], uninterrupted[3:], rtol=1e-6)

    # the reference's checkpoint, continued in the port
    b3, t3 = make(4, 1)
    state3, step = t3.restore(str(out / "ref_ck"))
    assert step == 3
    t3.fit(state3, 2, start_step=3)
    np.testing.assert_allclose([h["loss"] for h in t3.history], ref["ckpt"][3:], rtol=1e-4)


def test_scenario_and_sweep_on_model_axis_match_reference(reference):
    out, ref = reference
    want = ref["scenario"]
    cfg = P.make_tiny_workload()[0]
    params = interop.params_from_numpy(dict(np.load(out / "tiny.npz")), cfg, "cpu", 2)
    s = Scenario(n_workers=4, steps=3, bucket_bytes=4e6, lr=0.05, **CELL)
    r = P.run_trainer_scenario(s, data_par=4, model_par=2, device="cpu", params=params,
                               noise=_noise)
    np.testing.assert_allclose(r.series["loss_full"], want["loss"], rtol=1e-4)
    assert r.measured["wire_kb_per_step"] == want["wire_kb"]
    assert r.measured["wire_format_kb"] == want["formats"]
    (r2,), skipped = P.run_trainer_sweep([s], data_par=4, model_par=2, device="cpu",
                                         params=params, noise=_noise)
    assert not skipped
    np.testing.assert_array_equal(r2.series["loss_full"], r.series["loss_full"])
    assert r2.measured["wire_kb_per_step"] == want["wire_kb"]


def test_train_launcher_model_axis_on_cpu(capsys, tmp_path):
    assert launch_train.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                              "--workers", "2", "--model", "2", "--steps", "2", "--seq-len", "16",
                              "--global-batch", "4", "--warmup", "1", "--comm", "topk_ef",
                              "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "x 2 model shards" in out and "step     1 loss" in out
    with np.load(tmp_path / "step2" / "arrays.npz") as z:
        # the vocabulary padded for the 2 shards
        assert z["params/embed/embedding"].shape[0] % (128 * 2) == 0
