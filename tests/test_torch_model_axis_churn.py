"""Churn and integrity on the model axis against the reference's
``Trainer`` on a (data, model) = (4, 2) mesh, with the harness of
test_torch_model_axis_trainer.py (the tiny workload, 4 steps, the
reference's ``init_params(cfg, key(0), 2)``) and the noise and
``churn_draws`` hooks of test_torch_churn_trainer.py replaying the
reference's key chain (a worker's two shards share its draws, its
participation bit and its corruption flag).  Cells:

* BSP ``qsgd_kernel`` EF on the int8 compressed wire under 25% dropout and
  25% ``"nan"`` corruption, ``quarantine_limit`` 2: each shard corrupts and
  validates its own payload and keeps its own quarantine rows;
* BSP at dropout 0 with ``churn=True``: within rtol 1e-5 / atol 1e-6 of the
  reference's own output (its bitwise churn pins fail on this jax), and
  bitwise the port's churn-free cell;
* local SGD H 2 under 30% dropout, ``pull_avg`` and 50% ``"spike"``
  corruption of the sync wire: the validity voted over the unit's two
  shards, a booked scalar psum over ``model``;
* CHOCO-SGD gossip (qsgd 16 levels, lr 0.01) under 30% dropout.

Each: losses within rtol 1e-4 (CHOCO's last step within 2e-3, as
test_torch_model_axis_sync.py holds it); each program's booked wire by tag
equal to the reference's build-time artifact, and the (tag, axes) pairs of
the programs the run calls equal to those of the reference's capture, as
sets; the per-(worker, shard) ``alive_prev``, ``qcount``,
``quarantine_total`` and ``escalation_total`` equal to the reference's
global arrays, in the port's checkpoint layout, whose every path and shape
is the reference's state's.  test_torch_model_axis_options.py holds
PowerSGD, the pipelined step and ZeRO-1 over pod rows.  One 8-device
subprocess runs the reference for the module."""

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
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import flatten_with_paths, leaves
from test_torch_churn_trainer import churn_draws, pod_noise
from test_torch_model_axis_trainer import D, M, booked_wire, programs_run
from test_torch_sync import _noise, _one_thread  # noqa: F401

Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
            wire_format="compressed", error_feedback=True)
#: name -> (CommConfig fields, lr, microbatch, pods, optimizer); 4 steps
CELLS = {
    "bsp_nan": (dict(**Q_EF, dropout_rate=0.25, corruption_kind="nan", corruption_rate=0.25,
                     quarantine_limit=2), 0.05, 1, 1, ""),
    "churn0": (dict(**Q_EF, churn=True), 0.05, 1, 1, ""),
    "local_spike": (dict(sync="local", local_steps=2, rejoin_policy="pull_avg",
                         dropout_rate=0.3, corruption_kind="spike", corruption_rate=0.5),
                    0.05, 1, 1, ""),
    "choco": (dict(aggregator="gossip", gossip_compress="choco", compressor="qsgd",
                   compressor_kwargs={"levels": 16}, dropout_rate=0.3), 0.01, 1, 1, ""),
}
#: the per-(worker, shard) comm entries compared with the reference's
TALLIES = ("alive_prev", "pod_alive_prev", "qcount", "quarantine_total", "escalation_total")

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
TALLIES = ("alive_prev", "pod_alive_prev", "qcount", "quarantine_total", "escalation_total")
cfg, shape, data = make_tiny_workload()
np.savez(OUT, **{k: np.asarray(v, np.float32) for k, v in
                 flatten_with_paths(JT.init_params(cfg, jax.random.key(0), M)).items()})
out = {}
for name, (kw, lr, mb, pods, o) in CELLS.items():
    mesh = (make_test_mesh(data=D // pods, model=M, pod=pods) if pods > 1
            else make_test_mesh(data=D, model=M))
    opt = momentum_sgd(0.0)
    if o == "zero1":
        opt = zero1(opt, ("pod", "data") if pods > 1 else ("data",))
    b = build_bundle(cfg, mesh, CommConfig(bucket_mb=4.0, **kw), opt, shape, seed=0,
                     microbatch=mb, cache=False)
    tr = Trainer(b, data, constant(lr), log_every=1)
    state = tr.init(0)
    q0 = [np.asarray(q, np.float64).ravel().tolist() for q in state["comm"].get("psgd_q", [])]
    with comms.capture() as log:
        state = tr.fit(state, 4)
    keys = sorted({f"{r.tag or 'untagged'}|{','.join(r.axes)}" for r in log.records
                   if r.wire_bytes * r.mult})
    wire = {k: {t: v for t, v in w.items() if v} for k, w in b.wire.items()
            if not k.endswith("_formats")}
    c = state["comm"]
    out[name] = {"loss": [h["loss"] for h in tr.history], "wire": wire, "keys": keys, "q0": q0,
                 "comm": {k: np.asarray(c[k], np.float64).ravel().tolist()
                          for k in TALLIES if k in c},
                 "psgd_q": [np.asarray(q, np.float64).ravel().tolist()
                            for q in c.get("psgd_q", [])],
                 "shapes": {k: list(np.shape(v)) for k, v in flatten_with_paths(state).items()
                            if k not in ("step", "comm/step")}}
print("REF " + json.dumps(out))
"""


def run_reference(cells: dict, params_path) -> dict:
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={D * M}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(cells), str(D), str(M),
                          str(params_path)], capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return json.loads(run.stdout.split("REF ", 1)[1])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("model_axis_churn") / "params.npz"
    return run_reference(CELLS, path), dict(np.load(path))


def port_cell(cells: dict, name: str, flat: dict, ref: dict | None = None, **over):
    """The cell's 4 steps in the port from the reference's parameters (and
    its initial PowerSGD Q, when ``ref`` has one), one step a call; returns
    (bundle, losses, final state, each step's state checks)."""
    kw, lr, mb, pods, o = cells[name]
    cfg, shape, data = make_tiny_workload()
    comm = CommConfig(bucket_mb=4.0, **{**kw, **over})
    optim = opt.momentum_sgd(0.0)
    if o == "zero1":
        optim = opt.zero1(optim, D)
    b = build_bundle(cfg, comm, optim, shape, n_workers=D, seed=0, device="cpu",
                     noise=pod_noise if pods > 1 else _noise, churn_draws=churn_draws, model=M,
                     microbatch=mb, pods=pods, cache=False)
    tr = Trainer(b, data, constant(lr), log_every=1)
    state = b.init_state(interop.params_from_numpy(flat, cfg, "cpu", M))
    if ref is not None and ref["q0"]:  # the reference's key(1000 + i) draws, its layout
        state["comm"]["psgd_q"] = b.from_checkpoint(
            {"comm": {"psgd_q": [torch.tensor(q, dtype=torch.float32) for q in ref["q0"]]}}
        )["comm"]["psgd_q"]
    rows_equal = []
    for t in range(4):
        state = tr.fit(state, 1, start_step=t)
        if b.stacked:
            rows_equal.append(all(torch.equal(p[0], p[r]) for p in leaves(state["params"])
                                  for r in range(p.shape[0])))
    return b, np.asarray([h["loss"] for h in tr.history]), state, rows_equal


def assert_wire(b, ref: dict, name: str) -> None:
    """Each program's booked wire by tag equal to the reference's build-time
    artifact, and the (tag, axes) pairs of the programs the run calls equal
    to those of the reference's capture (as sets: the reference traces a
    churn program more than once)."""
    progs = [k for k in b.wire if not k.endswith("_formats")]
    assert progs and set(progs) <= set(ref["wire"]), (name, progs)
    for prog in progs:
        assert {k: v for k, v in b.wire[prog].items() if v} == pytest.approx(
            ref["wire"][prog]), (name, prog)
    assert sorted(k for k, v in booked_wire(b, programs_run(b.comm, 4)).items() if v) \
        == ref["keys"], name


def assert_cell_matches(cells: dict, name: str, ref: dict, got) -> None:
    b, losses, state, _ = got
    want = np.asarray(ref["loss"])
    if name == "choco":  # the reference's replicated leaves part across its shards
        np.testing.assert_allclose(losses[3], want[3], rtol=2e-3)
        losses, want = losses[:3], want[:3]
    np.testing.assert_allclose(losses, want, rtol=1e-4, err_msg=name)
    assert_wire(b, ref, name)
    tree = b.checkpoint_tree(state)  # the reference's global layout, every leaf
    # but diverging parameters and their optimizer state (unless ZeRO-1
    # slices it), which keep their rows here (W, or P pods; the reference's
    # global array holds one of its diverging copies)
    rowed = ("params/",) + (() if b.opt.n_shards else ("opt/",)) if b.stacked else ()
    assert {k: list(v.shape)[1 if k.startswith(rowed) else 0:]
            for k, v in flatten_with_paths(tree).items()
            if isinstance(v, torch.Tensor)} == ref["shapes"], name
    comm = tree["comm"]
    for k in TALLIES:
        assert (k in comm) == (k in ref["comm"]), (name, k)
        if k in ref["comm"]:
            assert comm[k].shape == (D * M,), (name, k)
            np.testing.assert_array_equal(comm[k].numpy(), ref["comm"][k], err_msg=f"{name}/{k}")


@pytest.mark.parametrize("name", [n for n in CELLS if n != "churn0"])
def test_churn_cell_on_model_axis_matches_reference(name, reference):
    ref, flat = reference
    got = port_cell(CELLS, name, flat)
    assert_cell_matches(CELLS, name, ref[name], got)
    comm = got[2]["comm"]
    if name == "bsp_nan":  # each shard validates its own payload; rounds were quarantined
        assert float(comm["quarantine_total"].sum()) > 0
    if name == "local_spike":  # the vote: both shards of a worker share its verdict
        q = comm["quarantine_total"].view(D, M)
        assert float(q.sum()) > 0 and torch.equal(q[:, 0], q[:, 1])
        vote = 2.0 * 4 * (M - 1) / M  # one f32 psum over the model axis
        assert got[0].wire["sync"]["untagged"] == ref[name]["wire"]["sync"]["untagged"] == vote


def test_dropout0_churn_on_model_axis_is_the_churn_free_cell(reference):
    """Dropout 0 under churn: within rtol 1e-5 / atol 1e-6 of the reference's
    output, every bit alive, and bitwise the port's churn-free cell (losses
    and every EF row)."""
    ref, flat = reference
    b, churn0, s0, _ = port_cell(CELLS, "churn0", flat)
    np.testing.assert_allclose(churn0, ref["churn0"]["loss"], rtol=1e-5, atol=1e-6)
    assert_wire(b, ref["churn0"], "churn0")
    assert s0["comm"]["alive_prev"].tolist() == [1.0] * (D * M)
    _, plain, s1, _ = port_cell(CELLS, "churn0", flat, churn=False)
    np.testing.assert_array_equal(churn0, plain)
    for a, c in zip(s0["comm"]["ef"], s1["comm"]["ef"]):
        assert torch.equal(a, c)
