"""The trainer on the model axis against the reference's ``Trainer`` on a
(data, model) = (4, 2) mesh: the tiny workload (qwen3-0.6b reduced, vocab
128 padded to 256 over the 2 shards), 4 steps at lr 0.05 from the
reference's ``init_params(cfg, key(0), 2)``, the noise hook replaying its
key chain (the shards of a worker share it).  Cells: BSP under top-k 10%
with error feedback (deterministic), ``qsgd_kernel`` on the int8
compressed wire with error feedback, signSGD majority and ZeRO-1 under BSP
here; local SGD (H 2), D-PSGD and CHOCO-SGD gossip (lr 0.01, as
test_torch_gossip.py runs it) in test_torch_model_axis_sync.py.  Losses within rtol 1e-4 (the reference's
replicated leaves part across its model shards under a compressed
exchange, each shard's bucket scaled by its own norm: 1.5% after these 4
qsgd_kernel steps, 0.9% under CHOCO; the port holds shard 0's: the
series agree, but for CHOCO's last step, 0.17% apart, held to 2e-3); the booked wire of the programs the run calls, by (tag, axes), equal
to the reference's capture of the same run to the byte (the model-axis
records included: the forward's row-parallel psums, the vocabulary-parallel
loss, ``tp_grad_fixup``; and ``grad_agg`` over the shard-local buckets).
One 8-device subprocess runs the reference for the module."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import interop
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.experiments.trainer_substrate import make_tiny_workload
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from test_torch_sync import _noise, _one_thread  # noqa: F401

D, M = 4, 2
Q = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16})
#: (CommConfig fields, lr) of each cell; 4 steps
CELLS = {
    "topk_ef": (dict(compressor="topk", compressor_kwargs={"ratio": 0.1}, error_feedback=True),
                0.05),
    "qsgd_kernel_ef": (dict(error_feedback=True, wire_format="compressed", **Q), 0.05),
    "signsgd": (dict(compressor="signsgd"), 0.05),
    "zero1": (dict(), 0.05),
}

REFERENCE = r"""
import json, sys
import jax, numpy as np
from repro.core import comms
from repro.core.types import CommConfig
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.optim.optimizers import momentum_sgd, zero1
from repro.optim.schedules import constant
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
from repro.utils.tree import flatten_with_paths
CELLS, D, M, OUT = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cfg, shape, data = make_tiny_workload()
mesh = make_test_mesh(data=D, model=M)
np.savez(OUT, **{k: np.asarray(v, np.float32) for k, v in
                 flatten_with_paths(JT.init_params(cfg, jax.random.key(0), M)).items()})
out = {}
for name, (kw, lr) in CELLS.items():
    o = momentum_sgd(0.0)
    if name == "zero1":
        o = zero1(o, ("data",))
    b = build_bundle(cfg, mesh, CommConfig(bucket_mb=4.0, **kw), o, shape, seed=0, cache=False)
    tr = Trainer(b, data, constant(lr), log_every=1)
    state = tr.init(0)
    with comms.capture() as log:
        tr.fit(state, 4)
    wire = {}
    for r in log.records:
        key = f"{r.tag or 'untagged'}|{','.join(r.axes)}"
        wire[key] = wire.get(key, 0.0) + r.wire_bytes * r.mult
    out[name] = {"loss": [h["loss"] for h in tr.history], "wire": wire}
print("REF " + json.dumps(out))
"""


def run_reference(cells: dict, d: int, m: int, params_path) -> dict:
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={d * m}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(cells), str(d), str(m),
                          str(params_path)], capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return json.loads(run.stdout.split("REF ", 1)[1])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("model_axis_trainer") / "params.npz"
    return run_reference(CELLS, D, M, path), dict(np.load(path))


def check_cell(name: str, kw: dict, lr: float, ref: dict, flat: dict) -> None:
    cfg, shape, data = make_tiny_workload()
    comm = CommConfig(bucket_mb=4.0, **kw)
    o = opt.momentum_sgd(0.0)
    if name == "zero1":
        o = opt.zero1(o, D)
    b = build_bundle(cfg, comm, o, shape, n_workers=D, seed=0, device="cpu", noise=_noise,
                     model=M, cache=False)
    tr = Trainer(b, data, constant(lr), log_every=1)
    tr.fit(b.init_state(interop.params_from_numpy(flat, cfg, "cpu", M)), 4)
    losses, want = [h["loss"] for h in tr.history], ref[name]["loss"]
    if name == "choco":  # the reference's replicated leaves part across its shards
        np.testing.assert_allclose(losses[3], want[3], rtol=2e-3)
        losses, want = losses[:3], want[:3]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    got = booked_wire(b, programs_run(comm, 4))
    assert any(k.endswith("|model") for k in got)
    assert got == ref[name]["wire"]


def programs_run(comm: CommConfig, steps: int) -> set[str]:
    from repro_torch.core import sync

    if comm.aggregator == "gossip":
        return {"gossip"}
    out = set()
    for t in range(steps):
        out.add("train" if sync.grads_need_aggregation(comm, t) else "inner")
        if sync.params_need_sync(comm, t):
            out.add("sync")
    return out


def booked_wire(bundle, programs) -> dict[str, float]:
    wire: dict[str, float] = {}
    for prog in programs:
        for r in bundle.logs[prog].records:
            key = f"{r.tag or 'untagged'}|{','.join(r.axes)}"
            wire[key] = wire.get(key, 0.0) + r.wire_bytes * r.mult
    return wire


@pytest.mark.parametrize("name", list(CELLS))
def test_trainer_on_model_axis_matches_reference(name, reference):
    ref, flat = reference
    check_cell(name, *CELLS[name], ref, flat)
