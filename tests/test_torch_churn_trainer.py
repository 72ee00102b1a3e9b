"""Churn, rejoin and integrity in the port's trainer (``repro_torch.train``
with ``repro_torch.core.aggregate``'s masked rounds), against the JAX
package's trainer; the harness of test_torch_churn_sync.py,
test_torch_churn_gossip.py and test_torch_integrity_trainer.py too.

* Each cell runs 4 steps of ``Trainer.fit`` on the tiny workload at W = 4
  from the reference's initial parameters, against the reference's
  ``build_bundle`` on a 4-device mesh driven by its ``Trainer``, every cell
  of a module in one subprocess: losses within rtol 1e-4, each program's
  booked wire by tag equal to the reference's build-time artifact, and the
  comm state's churn entries (``alive_prev``, ``pod_alive_prev``,
  ``qcount``, ``quarantine_total``, ``escalation_total``) exact.  The noise
  and churn hooks replay the reference's key chain:
  ``fold_in(key(0), step)``, the pipelined round, the worker's index over
  every data axis, then the ``0x6368`` (mask) and ``CORRUPT_FOLD``
  (corruption) folds.
* This module: the BSP cells the card drives as chip_smoke.py's (ag), (ah)
  and (ai): the int8 wire with EF under 30% dropout (window steps 1-3), its
  dropout-0 churn twin and the churn-free cell, and the 2-bit wire with 60%
  bitflip corruption and ``quarantine_limit`` 2.
* The dropout-0 churn cell equals the churn-free one bitwise in the port.
* On the card (gpu-marked): each churn path launches exactly its
  churn-free twin's kernels.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro_torch.core import integrity
from repro_torch.core.types import CommConfig
from repro_torch.kernels import ops
from test_torch_sync import _noise, _one_thread, cuda, port_run  # noqa: F401
from test_torch_sync import reference_in_subprocess

Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
            wire_format="compressed", error_feedback=True)
DROP = dict(dropout_rate=0.3, churn_start=1, churn_end=4)
#: name -> (CommConfig fields, microbatch, pods)
CELLS = {
    "ag": (dict(**Q_EF, **DROP), 1, 1),
    "ah": (dict(**Q_EF, churn=True), 1, 1),
    "plain": (dict(**Q_EF), 1, 1),
    "ai": (dict(compressor="terngrad_kernel", wire_format="compressed", error_feedback=True,
                corruption_rate=0.6, corruption_kind="bitflip", quarantine_limit=2), 1, 1),
}

#: the churn entries of the comm state compared exactly
TALLIES = ("alive_prev", "pod_alive_prev", "qcount", "quarantine_total", "escalation_total")

REFERENCE = r"""
import json
import numpy as np
from repro.core import comms as jcomms
from repro.core.types import CommConfig
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.launch.mesh import make_test_mesh
from repro.optim.optimizers import momentum_sgd
from repro.optim.schedules import constant
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
CELLS = json.loads('CELLS_JSON')
TALLIES = ("alive_prev", "pod_alive_prev", "qcount", "quarantine_total", "escalation_total")


def by_tag_axes(log):
    out = {}
    for r in log.records:
        b = r.wire_bytes * r.mult
        if b:
            key = (r.tag or "untagged") + "|" + ",".join(r.axes)
            out[key] = out.get(key, 0.0) + b
    return out


cfg, shape, data = make_tiny_workload()
out = {}
for name, (kw, mb, pods) in CELLS.items():
    if "compressor_kwargs" in kw:
        kw["compressor_kwargs"] = dict(kw["compressor_kwargs"])
    mesh = (make_test_mesh(data=4 // pods, model=1, pod=pods) if pods > 1
            else make_test_mesh(data=4, model=1))
    jb = build_bundle(cfg, mesh, CommConfig(**kw), momentum_sgd(0.0), shape, seed=0,
                      microbatch=mb)
    tr = Trainer(jb, data, constant(0.05), log_every=1)
    st = tr.init()
    logs = []
    for t in range(4):
        with jcomms.capture() as log:
            st = tr.fit(st, 1, start_step=t)
        logs.append(by_tag_axes(log))
    wire = {k: {t: b for t, b in v.items() if b} for k, v in jb.wire.items()
            if not k.endswith("_formats")}
    out[name] = {"loss": [float(h["loss"]) for h in tr.history], "wire": wire, "logs": logs,
                 "comm": {k: np.asarray(st["comm"][k], np.float64).ravel().tolist()
                          for k in TALLIES if k in st["comm"]}}
print("REF " + json.dumps(out))
"""


def churn_draws(step, worker, rnd=None):
    """The reference's churn uniforms: the step key, the pipelined round (if
    any), the worker, then the mask and corruption folds."""
    key = jax.random.fold_in(jax.random.key(0), step)
    if rnd is not None:
        key = jax.random.fold_in(key, rnd)
    key = jax.random.fold_in(key, worker)
    return tuple(torch.tensor(float(jax.random.uniform(jax.random.fold_in(key, fold), ())))
                 for fold in (integrity.MASK_FOLD, integrity.CORRUPT_FOLD))


def pod_noise(step, worker, bucket, n, rnd=None):
    """Worker d of every pod draws the same dither (the reference folds the
    index over the aggregation axes only)."""
    return _noise(step, worker % 2, bucket, n, rnd)


def run_cell(name, cells=CELLS, **kw):
    comm_kw, mb, pods = cells[name]
    return port_run(CommConfig(**comm_kw), microbatch=mb, pods=pods, churn_draws=churn_draws,
                    noise=pod_noise if pods > 1 else _noise, **kw)


@pytest.fixture(scope="module")
def reference():
    return reference_in_subprocess(REFERENCE, CELLS)


def nonzero(d):
    return {k: v for k, v in d.items() if v}


def by_tag_axes(log):
    """Nonzero booked bytes by "tag|axes" (the reference script's key)."""
    out = {}
    for r in log.records:
        if r.wire_bytes * r.mult:
            key = (r.tag or "untagged") + "|" + ",".join(r.axes)
            out[key] = out.get(key, 0.0) + r.wire_bytes * r.mult
    return out


def assert_matches(name, ref, got):
    bundle, _, state, losses = got
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-4, err_msg=name)
    # the reference also books programs its scheme never calls (a gossip
    # cell's train step): every program the port runs, against its twin
    progs = [k for k in bundle.wire if not k.endswith("_formats")]
    assert progs and set(progs) <= set(ref["wire"]), (name, progs)
    for prog in progs:
        assert nonzero(bundle.wire[prog]) == pytest.approx(ref["wire"][prog]), (name, prog)
    for k in TALLIES:
        assert (k in state["comm"]) == (k in ref["comm"]), (name, k)
        if k in ref["comm"]:
            np.testing.assert_array_equal(state["comm"][k].numpy(), ref["comm"][k],
                                          err_msg=f"{name}/{k}")


@pytest.mark.parametrize("name", list(CELLS))
def test_churn_cell_matches_reference_trainer(name, reference):
    assert_matches(name, reference[name], run_cell(name))


def test_dropout0_churn_cell_is_the_churn_free_cell_bitwise(reference):
    """(ah): the masked program at dropout 0 and the plain one, bitwise in
    the port, and the live mask all ones."""
    _, _, s0, churn0 = run_cell("ah")
    _, _, s1, plain = run_cell("plain")
    np.testing.assert_array_equal(churn0, plain)
    assert s0["comm"]["alive_prev"].tolist() == [1.0] * 4
    for a, b in zip(s0["comm"]["ef"], s1["comm"]["ef"]):
        assert torch.equal(a, b)


#: the kernels each path launches on the card, per step: (ag)-(am) as the
#: churn-free twins launch them
ON_CARD = {
    "ag": {"qsgd_ef": 4 * 4, "int8_acc": 4},
    "ai": {"terngrad": 4 * 4, "tern_pack": 4 * 4, "tern_acc": 4},
    "ak": {"sign_pack": 4 * 4, "sign_vote": 4},
}
#: the on-card cells' fields (one bucket: bucket_mb 4)
CARD_CELLS = {
    "ag": dict(**Q_EF, **DROP),
    "ai": dict(compressor="terngrad_kernel", wire_format="compressed", error_feedback=True,
               corruption_rate=0.6, corruption_kind="bitflip", quarantine_limit=2),
    "ak": dict(compressor="signsgd_packed", wire_format="compressed", error_feedback=True,
               **DROP),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ON_CARD))
def test_churn_paths_on_card_launch_their_twins_kernels(cuda, name):
    """One bucket (bucket_mb 4), 4 steps, W = 4: the launch counts are
    the churn-free twin's whatever the draws, and the losses agree with the
    CPU run's within rtol 1e-3."""
    cells = {name: (dict(CARD_CELLS[name], bucket_mb=4.0), 1, 1)}
    ops.reset_launches()
    _, _, _, on_card = run_cell(name, cells, device=cuda)
    want = {k: ON_CARD[name].get(k, 0) for k in ops.LAUNCHES}
    assert {k: ops.LAUNCHES[k] for k in want} == want
    _, _, _, on_cpu = run_cell(name, cells)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)
