"""``clip_norm`` on the model axis against the reference's ``Trainer`` on a
(data, model) = (1, 2) mesh: the reference's ``global_clip`` runs inside
``shard_map`` on each shard's local leaves, so each shard is clipped by
its own local norm (the replicated leaves, which every shard holds,
included).  The port does the same (``StepBundle._clip``: a sharded leaf's
block by its shard's factor, a replicated leaf by shard 0's).  The tiny
workload (qwen3-0.6b reduced, vocab 128 padded to 256 over the 2 shards),
4 steps at lr 0.5 from the reference's ``init_params(cfg, key(0), 2)``,
``clip_norm`` 0.1, which binds on both shards (their local gradient norms
start at ~0.2 and ~0.7; the cells check the first step).  Cells: the BSP
train step (dense f32 exchange) and local SGD's inner step (H 2).  Losses
within rtol 1e-4; a clip by the global norm, as the port had it, parts
from the reference by 1.0e-3 at the second step and 4.1e-3 at the fourth.
One 2-device subprocess runs the reference for the module."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core.types import CommConfig
from repro_torch.experiments.trainer_substrate import make_tiny_workload
from repro_torch.models.sharding import shard_local
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import leaves
from test_torch_sync import _noise, _one_thread  # noqa: F401

D, M, CLIP, LR, STEPS = 1, 2, 0.1, 0.5, 4
CELLS = {"bsp_dense": dict(), "local_inner": dict(sync="local", local_steps=2)}

REFERENCE = r"""
import json, sys
import jax, numpy as np
from repro.core.types import CommConfig
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.optim.optimizers import momentum_sgd
from repro.optim.schedules import constant
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
from repro.utils.tree import flatten_with_paths
CELLS, D, M, CLIP, LR, STEPS, OUT = json.loads(sys.argv[1]), *map(int, sys.argv[2:4]), \
    float(sys.argv[4]), float(sys.argv[5]), int(sys.argv[6]), sys.argv[7]
cfg, shape, data = make_tiny_workload()
mesh = make_test_mesh(data=D, model=M)
np.savez(OUT, **{k: np.asarray(v, np.float32) for k, v in
                 flatten_with_paths(JT.init_params(cfg, jax.random.key(0), M)).items()})
out = {}
for name, kw in CELLS.items():
    b = build_bundle(cfg, mesh, CommConfig(bucket_mb=4.0, **kw), momentum_sgd(0.0), shape,
                     seed=0, cache=False, clip_norm=CLIP)
    tr = Trainer(b, data, constant(LR), log_every=1)
    tr.fit(tr.init(0), STEPS)
    out[name] = [h["loss"] for h in tr.history]
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("model_axis_clip") / "params.npz"
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={D * M}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(CELLS), str(D), str(M),
                          str(CLIP), str(LR), str(STEPS), str(path)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return json.loads(run.stdout.split("REF ", 1)[1]), dict(np.load(path))


def _port(kw: dict, flat: dict):
    cfg, shape, data = make_tiny_workload()
    b = build_bundle(cfg, CommConfig(bucket_mb=4.0, **kw), opt.momentum_sgd(0.0), shape,
                     n_workers=D, seed=0, device="cpu", noise=_noise, model=M, clip_norm=CLIP,
                     cache=False)
    return b, Trainer(b, data, constant(LR), log_every=1), cfg


@pytest.mark.parametrize("name", list(CELLS))
def test_model_axis_clip_matches_reference(name, reference):
    ref, flat = reference
    b, tr, cfg = _port(CELLS[name], flat)
    state = b.init_state(interop.params_from_numpy(flat, cfg, "cpu", M))
    # the clip binds: each shard's local gradient norm is past clip_norm
    g, _ = b._grads(b._worker_params(state["params"], 0), b._split(
        tr._put(tr.data.batch(0)))[0], 1)
    norms = [float(torch.sqrt(sum(torch.sum(x.float() ** 2) for x in b.local_leaves(g, m))))
             for m in range(M)]
    assert min(norms) > 1.5 * CLIP, norms
    tr.fit(state, STEPS)
    np.testing.assert_allclose([h["loss"] for h in tr.history], ref[name], rtol=1e-4)


def test_clip_scales_each_shard_by_its_own_norm():
    """The arithmetic: shard m's factor min(1, c / ||local leaves of m||) on
    its block of every sharded leaf, shard 0's on the replicated leaves."""
    cfg, shape, _ = make_tiny_workload()
    b = build_bundle(cfg, CommConfig(bucket_mb=4.0), opt.sgd(), shape, n_workers=2,
                     device="cpu", model=M, clip_norm=CLIP, cache=False)
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(x.shape, generator=gen) for x in leaves(b._meta_state()["params"])]
    got = b._clip(grads)
    scale = [min(1.0, CLIP / float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                                  for x in b.local_leaves(grads, m)))))
             for m in range(M)]
    assert max(scale) < 1.0
    for g, h, d in zip(grads, got, b.shard_dims):
        if d is None:
            np.testing.assert_allclose(h.numpy(), g.numpy() * scale[0], rtol=1e-5)
            continue
        for m in range(M):
            np.testing.assert_allclose(shard_local(h, d, M, m).numpy(),
                                       shard_local(g, d, M, m).numpy() * scale[m], rtol=1e-5)
