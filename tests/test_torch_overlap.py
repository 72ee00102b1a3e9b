"""Microbatch-pipelined overlap in the port (``overlap="pipelined"``, the
reference's ``_pipelined_grads``) against the JAX package.

* Staleness 0 on the dense wire computes the sequential update: 4 steps
  with 2 microbatches equal the sequential run's losses and parameters
  within rtol 1e-5 / atol 1e-7 (the reference's own
  ``test_pipelined_staleness0_matches_sequential_dense`` tolerance).
* At W = 4 against ``run_trainer_scenario(data_par=4, microbatch=2,
  overlap="pipelined")``, one 4-device subprocess for the module: staleness
  0 (dense, and ``qsgd_kernel`` EF on the int8 compressed wire) and
  staleness 1 (qsgd EF, and dense): losses within rtol 1e-4, booked wire
  per step equal to ``measured["wire_kb_per_step"]`` (the M rounds of a
  step: ``comms.loop``).  The noise hook replays the reference's chain
  with the round folded in after the step.
* ``stale_scale`` 0.5 at W = 1 against the reference's own bundle and
  trainer.
* The first staleness-1 round compresses the zero-initialised
  ``overlap_pending``: a zero norm gives the reference's codes, norm and
  residual (zeros, no NaN), on the plain path here and on the kernel on
  the card.
* ``overlap_pending`` through a checkpoint: bitwise in the port (and the
  next step), and a W = 1 checkpoint of the pipelined step restores in the
  reference, every leaf equal, the next step's loss within rtol 1e-4.
* ``validate`` raises the reference's ``bundle_spec`` errors; a gossip
  cell accepts ``overlap="pipelined"`` and reads it nowhere.
* On the card: the staleness-1 qsgd EF cell at W = 4 (its rounds on the
  side stream) within rtol 1e-5 of the same cell on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.core.types import CommConfig as JCommConfig
from repro.core.types import bundle_spec
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.kernels import ops as jops
from repro.launch.mesh import make_test_mesh
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant as jconstant
from repro.train.steps import build_bundle as jbuild_bundle
from repro.train.trainer import Trainer as JTrainer
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch.core.types import CommConfig, validate
from repro_torch.kernels import ops
from repro_torch.train.trainer import wire_per_step
from repro_torch.utils.tree import flatten_with_paths
from test_torch_ckpt import deterministic  # noqa: F401
from test_torch_sync import _noise, _one_thread, cuda, port_run  # noqa: F401
from test_torch_sync import reference_in_subprocess

Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
            wire_format="compressed", error_feedback=True)
PIPE = dict(overlap="pipelined", bucket_mb=4.0)
#: (CommConfig fields) of each cell against the reference's trainer at W = 4,
#: 2 microbatches, lr 0.05, 4 steps
CELLS = {
    "s0-dense": dict(overlap_staleness=0),
    "s0-qsgd-ef": dict(overlap_staleness=0, **Q_EF),
    "s1-qsgd-ef": dict(overlap_staleness=1, **Q_EF),
    "s1-dense": dict(overlap_staleness=1),
}

REFERENCE = r"""
import json
from repro.experiments import Scenario
from repro.experiments.trainer_substrate import run_trainer_scenario
CELLS = json.loads('CELLS_JSON')
out = {}
for name, kw in CELLS.items():
    if "compressor_kwargs" in kw:
        kw["compressor_kwargs"] = tuple(sorted(kw["compressor_kwargs"].items()))
    s = Scenario(n_workers=4, steps=4, bucket_bytes=4e6, lr=0.05, microbatch=2,
                 overlap="pipelined", **kw)
    r = run_trainer_scenario(s, data_par=4)
    out[name] = {"loss": [float(x) for x in r.series["loss_full"]],
                 "wire_kb": r.measured["wire_kb_per_step"]}
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_series():
    return reference_in_subprocess(REFERENCE, CELLS)


def _flat(tree):
    return {k: v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in flatten_with_paths(tree).items()}


def test_staleness0_dense_equals_sequential():
    pipe = port_run(CommConfig(overlap_staleness=0, **PIPE), microbatch=2)
    seq = port_run(CommConfig(bucket_mb=4.0), microbatch=2)
    np.testing.assert_allclose(pipe[3], seq[3], rtol=1e-5, atol=1e-7)
    a, b = _flat(pipe[2]["params"]), _flat(seq[2]["params"])
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # M rounds per step: the comm state's step counts them, as the reference's
    assert pipe[2]["comm"]["step"] == 8 and seq[2]["comm"]["step"] == 4


@pytest.mark.parametrize("cell", list(CELLS))
def test_pipelined_matches_reference_trainer(cell, reference_series):
    bundle, _, state, losses = port_run(CommConfig(**PIPE, **CELLS[cell]), microbatch=2)
    want = reference_series[cell]
    np.testing.assert_allclose(losses, want["loss"], rtol=1e-4)
    assert wire_per_step(bundle, 4) / 1e3 == pytest.approx(want["wire_kb"], rel=1e-12)
    # one booked set of rounds, multiplied by the rounds of a step
    assert {r.mult for r in bundle.logs["train"].records if r.tag == "grad_agg"} == (
        {2.0} if CELLS[cell]["overlap_staleness"] == 1 else {1.0})
    assert ("overlap_pending" in state["comm"]) == (CELLS[cell]["overlap_staleness"] == 1)
    if cell == "s1-dense":  # staleness 1 is not staleness 0 run quietly
        assert np.abs(losses[1:] - reference_series["s0-dense"]["loss"][1:]).max() > 1e-7


def _reference_trainer(kw, microbatch=2):
    cfg, shape, data = make_tiny_workload()
    jb = jbuild_bundle(cfg, make_test_mesh(data=1, model=1), JCommConfig(**kw),
                       jopt.momentum_sgd(0.0), shape, seed=0, microbatch=microbatch,
                       cache=False)
    return JTrainer(jb, data, jconstant(0.05), log_every=1)


def test_stale_scale_matches_reference_bundle():
    kw = dict(stale_scale=0.5, **PIPE, **Q_EF)
    jt = _reference_trainer(kw)
    jt.fit(jt.init(), 3)
    _, _, _, losses = port_run(CommConfig(**kw), n_workers=1, steps=3, microbatch=2)
    np.testing.assert_allclose(losses, [h["loss"] for h in jt.history], rtol=1e-4)
    _, _, _, full = port_run(CommConfig(**PIPE, **Q_EF), n_workers=1, steps=3, microbatch=2)
    assert np.abs(losses[1:] - full[1:]).max() > 1e-7  # the knob bites


def test_zero_norm_round_gives_the_reference_codes():
    """Step 0's first staleness-1 round: g = 0 and e = 0."""
    n = 1000
    u = np.random.default_rng(3).random(n, dtype=np.float32)
    zeros = np.zeros(n, np.float32)
    jc, jn, je = jops.qsgd_ef_fused(jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(u),
                                    levels=16, decay=1.0)
    c, nrm, e = ops.qsgd_ef_fused(torch.zeros(n), torch.zeros(n), torch.from_numpy(u), 16, 1.0)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(nrm.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert not (c.any() or e.any()) and np.isfinite(nrm.numpy()).all()


@pytest.mark.gpu
def test_zero_norm_round_on_the_kernel(cuda):
    n = 100_003
    u = torch.rand(n, device=cuda)
    zeros = torch.zeros(n, device=cuda)
    ops.reset_launches()
    c, nrm, e = ops.qsgd_ef_fused(zeros, zeros, u, 16, 1.0)
    assert ops.LAUNCHES["qsgd_ef"] == 1
    want_c, want_n, want_e = ops.qsgd_ef_fused(zeros.cpu(), zeros.cpu(), u.cpu(), 16, 1.0)
    assert torch.equal(c.cpu(), want_c) and torch.equal(e.cpu(), want_e)
    assert torch.equal(nrm.cpu(), want_n) and not (c.any() or e.any())


def test_overlap_pending_round_trips_bitwise(tmp_path, deterministic):  # noqa: F811
    comm = CommConfig(**PIPE, **Q_EF)
    bundle, tr, state, _ = port_run(comm, n_workers=2, steps=2, microbatch=2)
    assert all(bool(p.any()) for p in state["comm"]["overlap_pending"])
    tr.save(str(tmp_path / "ck"), state, 2)
    tree = bundle.checkpoint_tree(state)
    assert [t.shape for t in tree["comm"]["overlap_pending"]] == [
        (2 * b.size,) for b in bundle.bucket_plan.buckets]  # the W rows concatenated
    back, step = tr.restore(str(tmp_path / "ck"))
    assert step == 2
    a, b = _flat(back), _flat(state)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    n = len(tr.history)
    state = tr.fit(state, 1, start_step=2)
    back = tr.fit(back, 1, start_step=2)
    assert tr.history[n]["loss"] == tr.history[n + 1]["loss"]
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v, _flat(state)[k], err_msg=k)


def test_pipelined_checkpoint_restores_in_the_reference(tmp_path):
    kw = dict(**PIPE, **Q_EF)
    bundle, tr, state, _ = port_run(CommConfig(**kw), n_workers=1, steps=2, microbatch=2)
    tr.save(str(tmp_path / "port"), state, 2)
    jt = _reference_trainer(kw)
    jstate, step = jrestore(str(tmp_path / "port"), jt.init())
    assert step == 2
    ref = {k: np.asarray(jnp.asarray(v, jnp.float32) if v.dtype == jnp.bfloat16 else v)
           for k, v in jflatten(jstate).items()}
    port = _flat(bundle.checkpoint_tree(state))
    assert port.keys() == ref.keys() and any("overlap_pending" in k for k in ref)
    for k in port:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    jt.fit(jstate, 1, start_step=2)
    tr.fit(state, 1, start_step=2)
    assert jt.history[-1]["loss"] == pytest.approx(tr.history[-1]["loss"], rel=1e-4)


BAD = [dict(overlap="bogus"), dict(overlap_staleness=2),
       dict(overlap="pipelined", sync="local", local_steps=2),
       dict(overlap="pipelined", sync="post_local", post_local_switch=2)]


@pytest.mark.parametrize("kw", BAD, ids=str)
def test_validate_raises_the_reference_bundle_spec_errors(kw):
    with pytest.raises(ValueError) as want:
        bundle_spec(JCommConfig(**kw))
    with pytest.raises(ValueError) as got:
        validate(CommConfig(**kw))
    assert str(got.value) == str(want.value)


def test_gossip_accepts_pipelined_and_reads_it_nowhere():
    kw = dict(aggregator="gossip", bucket_mb=4.0)
    bundle_spec(JCommConfig(overlap="pipelined", **kw))
    got = port_run(CommConfig(overlap="pipelined", overlap_staleness=0, **kw), steps=2)
    want = port_run(CommConfig(**kw), steps=2)
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.gpu
def test_staleness1_on_card_matches_cpu(cuda):
    """The staleness-1 qsgd EF cell at W = 4, 3 steps: the rounds run on
    the side stream and launch qsgd_ef per worker and bucket and int8_acc
    per bucket, twice a step; the losses within rtol 1e-5 of the CPU run."""
    comm = CommConfig(**PIPE, **CELLS["s1-qsgd-ef"])
    ops.reset_launches()
    _, _, state, on_card = port_run(comm, steps=3, microbatch=2, device=cuda,
                                    noise=lambda *a: _noise(*a).to(cuda))
    assert ops.LAUNCHES == {k: {"qsgd_ef": 3 * 2 * 4, "int8_acc": 3 * 2}.get(k, 0)
                            for k in ops.LAUNCHES}
    _, _, cpu_state, on_cpu = port_run(comm, steps=3, microbatch=2)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-5)
    assert all(bool(torch.isfinite(e).all()) for e in state["comm"]["ef"])
    assert len(cpu_state["comm"]["overlap_pending"]) == len(state["comm"]["overlap_pending"])
