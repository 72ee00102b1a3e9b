"""Pod-local SGD in the port on a two-level (pod, data) worker layout
(``build_bundle(..., pods=P)``: BSP inside each pod, parameter averaging
across pods every H steps), against the JAX package.

* The pod-local rules (every step aggregates, every H-th step syncs) equal
  the reference's over steps 0-9 for H 1, 2 and 3.
* ``average_params`` over the pod rows of a P 2 x D 2 layout equals the
  reference's under ``jax.vmap(jax.vmap(..., axis_name="data"),
  axis_name="pod")`` over ``("pod",)``: ring and rhd bitwise, ``xla``
  within rtol 1e-6; the records equal by kind, bytes, tag and axes.
* The whole path: 4 steps of ``Trainer.fit`` at P 2 x D 2, H 2, with
  ``qsgd_kernel`` on the int8 compressed wire and error feedback, against
  the reference's ``build_bundle`` on ``make_test_mesh(data=2, model=1,
  pod=2)`` driven by its ``Trainer``, in one 4-device subprocess: losses
  within rtol 1e-4, each pod's parameters after step 2 (the pods differ)
  within rtol 1e-4 and 1e-4 of the largest magnitude of the reference's
  shards, the booked wire of the
  train and sync programs equal by tag and axes.  The noise hook replays
  the reference's chain with the worker's index inside its pod, so worker
  d of both pods draws the same dither, as the reference's key does.
* ``pods=1`` is BSP plus the parameter sync over every worker: its losses
  are the BSP run's, and its wire that of ``run_trainer_scenario(
  pod_local=True, data_par=4)``.
* ``launch/train.py --pod 2 --workers 2 --pod-local`` runs on the CPU.
* ``powersgd`` over several pods keeps one Q per pod, as the reference does
  (its parity: test_torch_churn_pod.py).
* On the card: the whole path's cell launches exactly its kernels, once per
  worker (qsgd_ef) and once per pod (int8_acc) and step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comms as jcomms
from repro.core import sync as jsync
from repro.core.types import CommConfig as JCommConfig
from repro_torch.core import comms, sync
from repro_torch.core.types import CommConfig
from repro_torch.launch import train as launch_train
from repro_torch.train.trainer import wire_per_step
from repro_torch.kernels import ops
from test_torch_sync import _noise, _one_thread, cuda, port_run  # noqa: F401
from test_torch_sync import reference_in_subprocess

P, D = 2, 2
Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
            wire_format="compressed", error_feedback=True)
POD_CELL = dict(pod_local=True, local_steps=2, bucket_mb=4.0, **Q_EF)


@pytest.mark.parametrize("H", [1, 2, 3])
def test_pod_local_rules_match_reference(H):
    for kw in (dict(pod_local=True, local_steps=H),
               dict(pod_local=True, local_steps=H, sync="local")):  # pod_local overrides sync
        comm, jcomm = CommConfig(**kw), JCommConfig(**kw)
        for t in range(10):
            assert sync.grads_need_aggregation(comm, t) == jsync.grads_need_aggregation(jcomm, t)
            assert sync.grads_need_aggregation(comm, t)
            assert sync.params_need_sync(comm, t) == jsync.params_need_sync(jcomm, t)


AVG_SHAPES = {"a": (1000,), "b": (37, 11), "c": (4096,)}


def _records(log):
    return [(r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format, r.axes)
            for r in log.records]


@pytest.mark.parametrize("impl", ["xla", "ring", "rhd"])
def test_average_params_over_pods_matches_reference(impl):
    """Rows equal inside a pod, as pod-local SGD keeps them: the port holds
    one row per pod; the reference's (P, D) shards each average over the
    pod axis alone."""
    rng = np.random.default_rng(11)
    rows = {k: rng.standard_normal((P, *s)).astype(np.float32) for k, s in AVG_SHAPES.items()}
    rows["e"] = rng.standard_normal((P, 300)).astype(np.float32)  # held as bf16
    dt = {k: (jnp.bfloat16 if k == "e" else jnp.float32) for k in rows}
    jparams = {k: jnp.asarray(np.repeat(v[:, None], D, 1), dt[k]) for k, v in rows.items()}
    params = {k: torch.tensor(v).to(torch.bfloat16 if k == "e" else torch.float32)
              for k, v in rows.items()}
    run = jax.jit(jax.vmap(jax.vmap(lambda p: jsync.average_params(p, ("pod",), impl=impl),
                                    axis_name="data"), axis_name="pod"))
    with jcomms.capture() as jlog:
        want = jax.block_until_ready(run(jparams))
    with comms.capture() as log, comms.over(("pod",)):
        sync.average_params([params[k] for k in sorted(params)], impl=impl)
    assert _records(log) == _records(jlog)
    assert {(r.tag, r.axes, r.n_workers) for r in log.records} == {
        ("local_sgd_sync", ("pod",), P)}
    for k in sorted(params):
        w = np.asarray(jnp.asarray(want[k], jnp.float32))
        g = params[k].to(torch.float32).numpy()
        for d in range(D):
            if impl == "xla":
                np.testing.assert_allclose(g, w[:, d], rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(g, w[:, d])


REFERENCE = r"""
import json
import numpy as np
from repro.core import comms as jcomms
from repro.core.types import CommConfig
from repro.experiments import Scenario
from repro.experiments.trainer_substrate import make_tiny_workload, run_trainer_scenario
from repro.launch.mesh import make_test_mesh
from repro.optim.optimizers import momentum_sgd
from repro.optim.schedules import constant
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
kw = json.loads('CELLS_JSON')


def by_tag_axes(log):
    out = {}
    for r in log.records:
        b = r.wire_bytes * r.mult
        if b:
            key = (r.tag or "untagged") + "|" + ",".join(r.axes)
            out[key] = out.get(key, 0.0) + b
    return out


cfg, shape, data = make_tiny_workload()
jb = build_bundle(cfg, make_test_mesh(data=2, model=1, pod=2), CommConfig(**kw),
                  momentum_sgd(0.0), shape, seed=0, cache=False)
tr = Trainer(jb, data, constant(0.05), log_every=1)
st = tr.init()
with jcomms.capture() as tlog:
    st = tr.fit(st, 1)
with jcomms.capture() as slog:
    st = tr.fit(st, 1, start_step=1)
st = tr.fit(st, 1, start_step=2)
emb = st["params"]["embed"]["embedding"]
shards = sorted(emb.addressable_shards, key=lambda s: s.device.id)
step2 = [np.asarray(s.data, np.float32).ravel().tolist() for s in shards]
st = tr.fit(st, 1, start_step=3)
s = Scenario(n_workers=4, steps=4, bucket_bytes=4e6, lr=0.05, pod_local=True, local_steps=2)
r = run_trainer_scenario(s, data_par=4)
print("REF " + json.dumps({
    "loss": [h["loss"] for h in tr.history], "train": by_tag_axes(tlog),
    "sync": by_tag_axes(slog), "step2": step2,
    "pods1": {"loss": [float(x) for x in r.series["loss_full"]],
              "wire_kb": r.measured["wire_kb_per_step"]}}))
"""


@pytest.fixture(scope="module")
def reference_pods():
    return reference_in_subprocess(REFERENCE, POD_CELL)


def _by_tag_axes(log):
    out = {}
    for r in log.records:
        b = r.wire_bytes * r.mult
        if b:
            key = (r.tag or "untagged") + "|" + ",".join(r.axes)
            out[key] = out.get(key, 0.0) + b
    return out


def test_pod_local_path_matches_reference_trainer(reference_pods):
    bundle, _, _, losses = port_run(CommConfig(**POD_CELL), steps=3, pods=P)
    np.testing.assert_allclose(losses, reference_pods["loss"][:3], rtol=1e-4)
    # wire: in-pod aggregation over ("data",) n 2, the sync over ("pod",) n 2
    assert _by_tag_axes(bundle.logs["train"]) == pytest.approx(reference_pods["train"],
                                                               rel=1e-12)
    assert _by_tag_axes(bundle.logs["sync"]) == pytest.approx(reference_pods["sync"], rel=1e-12)
    assert not bundle.logs["train"].by_axes("grad_agg").get(("pod",))
    assert {r.n_workers for r in bundle.logs["train"].records if r.tag == "grad_agg"} == {D}


def test_pod_rows_match_reference_shards(reference_pods):
    """After step 2 (step 1 synced the pods) each pod's row equals the
    reference's shards of that pod, and the two pods differ; after step 3
    (a sync) they are equal."""
    _, tr, state, losses = port_run(CommConfig(**POD_CELL), steps=3, pods=P)
    emb = state["params"]["embed"]["embedding"]
    assert emb.shape[0] == P and not torch.equal(emb[0], emb[1])
    ref = np.asarray(reference_pods["step2"], np.float32).reshape(P * D, -1)
    # within float noise (1.3e-6 at most here); a dither drawn per pod
    # instead of shared moves the rows by 3e-2
    for w in range(P * D):
        np.testing.assert_allclose(emb[w // D].float().numpy().ravel(), ref[w], rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    state = tr.fit(state, 1, start_step=3)
    emb = state["params"]["embed"]["embedding"]
    assert torch.equal(emb[0], emb[1])
    np.testing.assert_allclose([h["loss"] for h in tr.history], reference_pods["loss"],
                               rtol=1e-4)


def test_one_pod_is_bsp_plus_the_sync(reference_pods):
    """pods=1: the in-pod aggregation is over every worker and the sync
    averages every worker's (equal) parameters, as the reference without a
    pod axis; its losses are BSP's and its wire the reference's."""
    kw = dict(pod_local=True, local_steps=2, bucket_mb=4.0)
    bundle, _, state, losses = port_run(CommConfig(**kw), pods=1)
    _, _, _, bsp = port_run(CommConfig(bucket_mb=4.0))
    np.testing.assert_allclose(losses, bsp, rtol=1e-6)
    np.testing.assert_allclose(losses, reference_pods["pods1"]["loss"], rtol=1e-4)
    assert wire_per_step(bundle, 4) / 1e3 == pytest.approx(reference_pods["pods1"]["wire_kb"],
                                                           rel=1e-12)
    assert set(bundle.logs["sync"].by_axes()) == {("data",)}
    assert state["params"]["embed"]["embedding"].shape[0] == 1


def test_train_launcher_runs_pod_local(capsys):
    assert launch_train.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                              "--pod", "2", "--workers", "2", "--pod-local",
                              "--local-steps", "2", "--steps", "2", "--seq-len", "16",
                              "--global-batch", "4", "--warmup", "1"]) == 0
    out = capsys.readouterr().out
    assert "4 workers (2 pods x 2)" in out and "step     1 loss" in out


@pytest.mark.gpu
def test_pod_local_on_card_launches_its_kernels(cuda):
    """The whole path's cell on the card, 4 steps at P 2 x D 2 (one
    bucket): qsgd_ef once per worker and step, int8_acc once per pod and
    step; the losses close to the CPU run's (other sum orders in the model:
    rtol 1e-3, as the other card cells) and the pods' rows equal after the
    last step, a sync step."""
    ops.reset_launches()
    _, _, state, on_card = port_run(CommConfig(**POD_CELL), pods=P, device=cuda,
                                    noise=lambda *a: _noise(*a).to(cuda))
    assert ops.LAUNCHES == {k: {"qsgd_ef": 4 * P * D, "int8_acc": 4 * P}.get(k, 0)
                            for k in ops.LAUNCHES}
    _, _, _, on_cpu = port_run(CommConfig(**POD_CELL), pods=P)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)
    emb = state["params"]["embed"]["embedding"]
    assert torch.equal(emb[0], emb[1])


def test_powersgd_over_several_pods_is_refused():
    """Nothing refuses it now: the port keeps one PowerSGD Q per pod under
    pod-local SGD, as the reference does, a (P, b * rank) stack, and one pod
    keeps the flat Q."""
    kw = dict(pod_local=True, local_steps=2, bucket_mb=4.0, compressor="powersgd",
              compressor_kwargs={"rank": 2})
    _, _, state, losses = port_run(CommConfig(**kw), steps=1, pods=P)
    assert np.isfinite(losses).all()
    assert all(q.shape[0] == P for q in state["comm"]["psgd_q"] if q.numel())
    _, _, state, losses = port_run(CommConfig(**kw), steps=1, pods=1)
    assert np.isfinite(losses).all()
    assert all(q.dim() == 1 for q in state["comm"]["psgd_q"])
