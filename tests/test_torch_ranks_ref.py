"""The main path over ranks against the reference: ``qsgd_kernel`` on the
int8 compressed wire with error feedback under ``momentum_sgd(0.9)``, the
tiny workload at W = 4 over R = 2 gloo processes on the CPU, against the
reference's ``Trainer`` at data 4 on forced host devices (one 4-device
subprocess), 3 steps at lr 0.05 from the reference's
``init_params(cfg, key(0), 1)``.  The reference's key chain reaches the
ranks as a table of its draws (``torch_ranked.table_noise``), recorded from the
stacked port's run under ``test_torch_sync._noise``.  Losses within rtol
1e-4, and the booked train program by (tag, axes) equal to the
reference's capture of its run to the byte (its records over the model
axis of size 1 are 0 bytes), on both ranks; the ranks hold the stacked
run's losses, parameters and EF rows bitwise."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.experiments.trainer_substrate import make_tiny_workload as jtiny
from repro.models import transformer as JT
from repro.utils.tree import flatten_with_paths as jflatten
from test_torch_ranks import W, cell, run_ranked, run_stacked
from test_torch_sync import _noise, _one_thread  # noqa: F401

COMM = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
            wire_format="compressed", error_feedback=True, bucket_mb=0.5)
LR, STEPS = 0.05, 3

REFERENCE = r"""
import json, sys
from repro.core import comms
from repro.core.types import CommConfig
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.launch.mesh import make_test_mesh
from repro.optim.optimizers import momentum_sgd
from repro.optim.schedules import constant
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
kw, D, LR, STEPS = json.loads(sys.argv[1]), int(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4])
cfg, shape, data = make_tiny_workload()
b = build_bundle(cfg, make_test_mesh(data=D, model=1), CommConfig(**kw), momentum_sgd(0.9),
                 shape, seed=0, cache=False)
tr = Trainer(b, data, constant(LR), log_every=1)
with comms.capture() as log:
    tr.fit(tr.init(0), STEPS)
wire = {}
for r in log.records:
    key = f"{r.tag or 'untagged'}|{','.join(r.axes)}"
    wire[key] = wire.get(key, 0.0) + r.wire_bytes * r.mult
print("REF " + json.dumps({"loss": [h["loss"] for h in tr.history], "wire": wire}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks_ref")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(COMM), str(W), str(LR),
                            str(STEPS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    try:
        params = root / "params.npz"
        np.savez(params, **{k: np.asarray(v, np.float32) for k, v in jflatten(
            JT.init_params(jtiny()[0], jax.random.key(0), 1)).items()})
        draws = {}

        def recording(step, worker, bucket, n, rnd=None):
            u = _noise(step, worker, bucket, n, rnd)
            draws[f"{step}/{worker}/{bucket}"] = u.numpy()
            return u

        main = cell("main", comm=COMM, lr=LR, steps=STEPS, params=str(params))
        import torch_ranked

        real = torch_ranked.table_noise
        torch_ranked.table_noise = lambda path, device: recording  # the stacked run records them
        try:
            stacked = run_stacked(dict(main, noise="recorded"))
        finally:
            torch_ranked.table_noise = real
        table = root / "noise.npz"
        np.savez(table, **draws)
        got = run_ranked([dict(main, noise=str(table))], 2, root)["main"]
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return json.loads(out.split("REF ", 1)[1]), stacked, got


def test_main_path_over_ranks_matches_reference_losses(runs):
    ref, stacked, ranked = runs
    np.testing.assert_allclose(stacked["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(ranked[0]["loss"], ref["loss"], rtol=1e-4)


def test_main_path_over_ranks_books_the_reference_wire(runs):
    ref, _, ranked = runs
    # the reference books its model axis of size 1 too, at 0 bytes
    wire = {k: v for k, v in ref["wire"].items() if v}
    assert any(k.startswith("grad_agg|") for k in wire)
    for rec in ranked:
        assert json.loads(str(rec["booked"])) == wire


def test_main_path_over_ranks_is_the_stacked_run(runs):
    _, stacked, ranked = runs
    np.testing.assert_array_equal(ranked[0]["loss"], stacked["loss"])
    for rec in ranked:
        for k, v in rec.items():
            if k.startswith(("param/", "ef/")):
                np.testing.assert_array_equal(v, stacked[k], err_msg=k)
    assert any(k.startswith("ef/") for k in ranked[1])
    assert torch.get_num_threads() == 1
