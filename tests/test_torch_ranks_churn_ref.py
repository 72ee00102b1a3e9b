"""The pipelined step, churn and integrity over ranks against the reference:
the tiny workload at W = 4 over R = 2 gloo processes on the CPU, against
the reference's ``Trainer`` at data 4 on forced host devices (one 4-device
subprocess running the three cells in turn), 3 steps under
``momentum_sgd(0.9)`` from the reference's ``init_params(cfg, key(0), 1)``:

* the pipelined step at staleness 1, 2 microbatches, ``qsgd_kernel`` EF;
* BSP ``churn_qsgd`` (``qsgd_kernel`` EF, 25% dropout, 25% NaN,
  ``quarantine_limit`` 2);
* CHOCO-SGD over ``qsgd_kernel`` (16 levels) under 25% dropout, lr 0.01
  (as test_torch_ranks_sync_ref.py holds CHOCO-SGD).

The reference's key chain reaches the ranks as tables of its draws
(``torch_ranked.table_noise`` and ``table_churn``: the compressors'
uniforms by step, round, worker and bucket; each worker's mask and
corruption uniforms by step, round and worker), recorded from the stacked
port's run under ``test_torch_sync._noise`` and
``test_torch_churn_trainer.churn_draws``.  Losses within rtol 1e-4; the
churn and integrity vectors, gathered from the ranks' own rows, equal to
the reference's; and the wire: the pipelined cell's booked train program
by (tag, axes) equal to the reference's capture of its run to the byte,
the churn cells' each program by (tag, axes) equal to the reference's
build-time artifact of that program to the byte (its capture traces a
churn program more than once and counts it so,
test_torch_model_axis_churn.py; it books a train program for a gossip
cell too, which never runs) and the (tag, axes) pairs of the reference's
capture those the programs book.  The
ranks hold the stacked run's losses bitwise."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_ranked
from repro.experiments.trainer_substrate import make_tiny_workload as jtiny
from repro.models import transformer as JT
from repro.utils.tree import flatten_with_paths as jflatten
from test_torch_churn_trainer import churn_draws
from test_torch_ranks import W, cell, run_ranked, run_stacked
from test_torch_sync import _noise, _one_thread  # noqa: F401

Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, wire_format="compressed",
            error_feedback=True, bucket_mb=0.5)
#: name -> (CommConfig fields, lr, microbatch)
CELLS = {
    "pipelined_s1": (dict(Q_EF, overlap="pipelined", overlap_staleness=1), 0.05, 2),
    "churn_qsgd": (dict(Q_EF, dropout_rate=0.25, corruption_kind="nan", corruption_rate=0.25,
                        quarantine_limit=2), 0.05, 1),
    "choco_churn": (dict(aggregator="gossip", gossip_compress="choco", compressor="qsgd_kernel",
                         compressor_kwargs={"levels": 16}, bucket_mb=0.5, dropout_rate=0.25),
                    0.01, 1),
}
STEPS = 3
TALLIES = ("alive_prev", "qcount", "quarantine_total", "escalation_total")

REFERENCE = r"""
import json, sys
import numpy as np
from repro.core import comms
from repro.core.types import CommConfig
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.launch.mesh import make_test_mesh
from repro.optim.optimizers import momentum_sgd
from repro.optim.schedules import constant
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
CELLS, D, STEPS = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
TALLIES = ("alive_prev", "qcount", "quarantine_total", "escalation_total")
cfg, shape, data = make_tiny_workload()
out = {}
for name, (kw, lr, mb) in CELLS.items():
    b = build_bundle(cfg, make_test_mesh(data=D, model=1), CommConfig(**kw), momentum_sgd(0.9),
                     shape, seed=0, microbatch=mb, cache=False)
    tr = Trainer(b, data, constant(lr), log_every=1)
    with comms.capture() as log:
        st = tr.fit(tr.init(0), STEPS)
    capture = {}
    for r in log.records:
        key = f"{r.tag or 'untagged'}|{','.join(r.axes)}"
        capture[key] = capture.get(key, 0.0) + r.wire_bytes * r.mult
    out[name] = {"loss": [float(h["loss"]) for h in tr.history], "capture": capture,
                 "wire": {k: {t: v for t, v in w.items() if v} for k, w in b.wire.items()
                          if not k.endswith("_formats")},
                 "comm": {k: np.asarray(st["comm"][k], np.float64).ravel().tolist()
                          for k in TALLIES if k in st["comm"]}}
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks_churn_ref")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(CELLS), str(W),
                            str(STEPS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    try:
        params = root / "params.npz"
        np.savez(params, **{k: np.asarray(v, np.float32) for k, v in jflatten(
            JT.init_params(jtiny()[0], jax.random.key(0), 1)).items()})
        stacked, cells = {}, []
        real = torch_ranked.table_noise, torch_ranked.table_churn
        for name, (kw, lr, mb) in CELLS.items():
            noise, churn, tables = torch_ranked.recording(_noise, churn_draws)
            c = cell(name, comm=kw, lr=lr, steps=STEPS, microbatch=mb, params=str(params))
            torch_ranked.table_noise = lambda path, device, f=noise: f
            torch_ranked.table_churn = lambda path, device, f=churn: f
            try:  # the stacked run records the reference's draws
                stacked[name] = run_stacked(dict(c, noise="recorded", churn="recorded"))
            finally:
                torch_ranked.table_noise, torch_ranked.table_churn = real
            for kind in ("noise", "churn"):
                np.savez(root / f"{kind}_{name}.npz", **tables[kind])
            cells.append(dict(c, noise=str(root / f"noise_{name}.npz"),
                              churn=str(root / f"churn_{name}.npz")))
        got = run_ranked(cells, 2, root)
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return json.loads(out.split("REF ", 1)[1]), stacked, got


@pytest.mark.parametrize("name", list(CELLS))
def test_over_ranks_matches_reference_losses(name, runs):
    ref, stacked, ranked = runs
    np.testing.assert_allclose(stacked[name]["loss"], ref[name]["loss"], rtol=1e-4)
    np.testing.assert_allclose(ranked[name][0]["loss"], ref[name]["loss"], rtol=1e-4)
    np.testing.assert_array_equal(ranked[name][0]["loss"], stacked[name]["loss"])


@pytest.mark.parametrize("name", [n for n in CELLS if n != "pipelined_s1"])
def test_over_ranks_tallies_are_the_references(name, runs):
    ref, _, ranked = runs
    assert set(ref[name]["comm"]) == {k for k in TALLIES if f"{k}/0" in ranked[name][0]
                                      or f"{k}/{W - 1}" in ranked[name][1]}
    for k, want in ref[name]["comm"].items():
        got = [float(rec[f"{k}/{w}"]) for w in range(W) for rec in ranked[name]
               if f"{k}/{w}" in rec]
        assert got == want, (name, k)
    if name == "churn_qsgd":
        assert sum(ref[name]["comm"]["quarantine_total"]) > 0


def _by_tag_axes(programs: dict, names) -> dict:
    got: dict[str, float] = {}
    for prog in names:
        for k, v in programs[prog].items():
            got[k] = got.get(k, 0.0) + v
    return {k: v for k, v in got.items() if v}


@pytest.mark.parametrize("name", list(CELLS))
def test_over_ranks_books_the_reference_wire(name, runs):
    ref, _, ranked = runs
    capture = {k: v for k, v in ref[name]["capture"].items() if v}  # model axis of size 1: 0 B
    assert capture
    for rec in ranked[name]:
        programs = json.loads(str(rec["programs"]))
        if name == "pipelined_s1":
            assert _by_tag_axes(programs, ["train"]) == capture
            continue
        for prog in programs:  # every record over the data axis
            wire = ref[name]["wire"][prog]
            assert _by_tag_axes(programs, [prog]) == {f"{t}|data": v for t, v in wire.items()}
        assert set(_by_tag_axes(programs, programs)) == set(capture)
