"""Churn and integrity over ranks of the data axis: the tiny workload at W =
4 over R = 2 (and R = 4) gloo processes on the CPU (the tests' harness
``torch_ranked``; torch on one thread in every rank), 3 steps at lr 0.05
under ``momentum_sgd(0.9)``, bucket_mb 0.5, the seeded churn draws,
against the same cells stacked in this process.  Each rank draws only its
own workers' bits and corruption flags, holds only their rows of the churn
and integrity vectors, and validates the other ranks' payloads from their
gathered bytes.

* BSP ``churn_qsgd`` (``qsgd_kernel`` EF, 25% dropout, 25% NaN,
  ``quarantine_limit`` 2; at R = 2 and R = 4), churn and corruption on the
  2-bit ``tern`` route (bitflip), the dense route (NaN) on the ``ring``
  schedule and on the ``xla`` psum (whose f32 running sum adds the ranks'
  partials: within rtol 1e-6, as test_torch_ranks_routes.py holds it), the
  ``gather`` route (plain ``qsgd`` on the dense wire, NaN), an escalation
  (``quarantine_limit`` 1), churn under the pipelined step at staleness 1
  and 0, local SGD (H 2) with ``pull_avg`` rejoins and spike corruption of
  its sync, pod-local SGD at one pod (its pod bit from the workers' bits,
  moved by the booked psum), D-PSGD and CHOCO-SGD (``qsgd_kernel``) under 30% dropout with
  ``pull_avg``.  Bitwise: losses, parameters, EF and momentum rows,
  ``overlap_pending``, the churn and integrity vectors (each rank holding
  its own W/R entries), the records captured and every booked program;
  each rank's ``churn_draws`` called for its own workers only, and the
  ranks together for every draw the stacked run made; the cells are not
  vacuous (workers dropped, payloads quarantined, an escalation).
* A targeted cell (a table of the churn uniforms): only worker 3, rank 1's,
  sends a NaN payload, at step 1.  Rank 0, which never draws worker 3,
  excludes it from the aggregate by its gathered bytes: the parameters are
  bitwise the stacked run's and the twin's in which worker 3 is dropped at
  that step instead, and only worker 3's quarantine tally counts."""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro_torch.core.aggregate import bucket_route
from test_torch_ranks import W, cell, check_against_stacked, run_ranked, run_stacked
from test_torch_sync import _one_thread  # noqa: F401
from torch_ranked import make_cell

Q_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, wire_format="compressed",
            error_feedback=True, bucket_mb=0.5)
NAN = dict(dropout_rate=0.25, corruption_kind="nan", corruption_rate=0.25, quarantine_limit=2)
CHURN_QSGD = dict(Q_EF, **NAN)
PULL = dict(dropout_rate=0.3, rejoin_policy="pull_avg")
#: name -> (cell keys, diverging parameter rows, the route of every bucket or None)
CELLS = {
    "churn_qsgd": (dict(comm=CHURN_QSGD), 0, "fused_ef"),
    "tern_bitflip": (dict(comm=dict(compressor="terngrad_kernel", wire_format="compressed",
                                    error_feedback=True, bucket_mb=0.5, dropout_rate=0.25,
                                    corruption_kind="bitflip", corruption_rate=0.5,
                                    quarantine_limit=2)), 0, "tern"),
    "dense_nan_ring": (dict(comm=dict(bucket_mb=0.5, collective="ring", **NAN)), 0, "dense"),
    "dense_nan_xla": (dict(comm=dict(bucket_mb=0.5, **NAN)), 0, "dense"),
    "gather_nan": (dict(comm=dict(compressor="qsgd", compressor_kwargs={"levels": 16},
                                  bucket_mb=0.5, **NAN)), 0, "gather"),
    "escalate": (dict(comm=dict(Q_EF, corruption_kind="nan", corruption_rate=0.5,
                                quarantine_limit=1)), 0, "fused_ef"),
    "pipe_s1": (dict(comm=dict(CHURN_QSGD, overlap="pipelined", overlap_staleness=1),
                     microbatch=2), 0, "fused_ef"),
    "pipe_s0": (dict(comm=dict(CHURN_QSGD, overlap="pipelined", overlap_staleness=0),
                     microbatch=2), 0, "fused_ef"),
    "local_pull_spike": (dict(comm=dict(sync="local", local_steps=2, corruption_kind="spike",
                                        corruption_rate=0.5, quarantine_limit=1, **PULL)), W,
                         None),
    "pod_local_churn": (dict(comm=dict(Q_EF, pod_local=True, local_steps=2, dropout_rate=0.3)),
                        1, "fused_ef"),
    "dpsgd_pull": (dict(comm=dict(aggregator="gossip", bucket_mb=0.5, **PULL)), W, None),
    "choco_pull": (dict(comm=dict(aggregator="gossip", gossip_compress="choco",
                                  compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
                                  bucket_mb=0.5, **PULL)), W, None),
}
#: the targeted cells: worker 3 NaN-corrupted, or dropped, at step 1 alone
TARGET = dict(Q_EF, dropout_rate=0.25, corruption_kind="nan", corruption_rate=0.5,
              quarantine_limit=5)


def _target_table(path, mask3: float, corrupt3: float) -> str:
    """Every worker alive and clean (uniforms 0.9) but worker 3 at step 1."""
    table = {f"{t}/{w}": np.array([mask3, corrupt3] if (t, w) == (1, 3) else [0.9, 0.9],
                                  np.float32) for t in range(2) for w in range(W)}
    np.savez(path, **table)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks_churn")
    cells = [cell(n, **kw) for n, (kw, _, _) in CELLS.items()]
    cells += [cell("target_nan", steps=2, comm=TARGET,
                   churn=_target_table(root / "nan.npz", 0.9, 0.0)),
              cell("target_drop", steps=2, comm=TARGET,
                   churn=_target_table(root / "drop.npz", 0.0, 0.9))]
    for d in ("r2", "r4"):
        os.makedirs(root / d)
    with ThreadPoolExecutor(2) as pool:
        launches = {2: pool.submit(run_ranked, cells, 2, root / "r2"),
                    4: pool.submit(run_ranked, [cell("churn_qsgd", **CELLS["churn_qsgd"][0])], 4,
                                   root / "r4")}
        stacked = {c["name"]: run_stacked(c) for c in cells}
        ranked = {w: f.result() for w, f in launches.items()}
    return stacked, ranked


def _drawn(rec) -> set:
    return {tuple(d) for d in json.loads(str(rec["drawn"]))}


@pytest.mark.parametrize("name", list(CELLS))
def test_churn_over_ranks_matches_stacked(name, runs):
    stacked, ranked = runs
    kw, rows, route = CELLS[name]
    if route is not None:  # the route the cell means to hold
        bundle = make_cell(cell(name, **kw), None, "cpu")[0]
        assert {bucket_route(bundle.comm, bundle.bucket_plan.compressor(b))
                for b in bundle.bucket_plan.buckets} == {route}
    assert np.isfinite(stacked[name]["loss"]).all()
    # the f32 running sum over each rank's workers adds the ranks' partials:
    # within rtol 1e-6, as test_torch_ranks_routes.py holds it
    check_against_stacked(stacked[name], ranked[2][name], bitwise=name != "dense_nan_xla",
                          rows=rows)
    drawn = [_drawn(rec) for rec in ranked[2][name]]
    assert drawn[0] and drawn[1]
    for r, d in enumerate(drawn):  # each rank draws its own workers only
        assert {w for _, w, _ in d} == {2 * r, 2 * r + 1}, (r, sorted(d)[:4])
    assert drawn[0] | drawn[1] == _drawn(stacked[name])


def test_churn_cells_are_not_vacuous(runs):
    """Over the cells' steps workers were dropped and rejoined (a rejoin
    resets rows), payloads quarantined, and the escalation cells escalated:
    the stacked tallies, which the ranks' rows equal."""
    stacked, _ = runs

    def total(name, key):
        return sum(float(v) for k, v in stacked[name].items() if k.startswith(key + "/"))

    for name, (kw, _, _) in CELLS.items():
        comm = kw["comm"]
        if comm.get("corruption_kind") and not comm.get("sync"):
            assert total(name, "quarantine_total") > 0, name
        if comm.get("quarantine_limit") == 1:
            assert total(name, "escalation_total") > 0, name
    assert any(total(n, "alive_prev") < W for n in CELLS if "alive_prev/0" in stacked[n])


def test_churn_qsgd_over_four_ranks_matches_stacked(runs):
    stacked, ranked = runs
    check_against_stacked(stacked["churn_qsgd"], ranked[4]["churn_qsgd"])
    for r, rec in enumerate(ranked[4]["churn_qsgd"]):
        assert {w for _, w, _ in _drawn(rec)} == {r}


@pytest.mark.parametrize("name", ["target_nan", "target_drop"])
def test_targeted_cells_match_stacked(name, runs):
    stacked, ranked = runs
    check_against_stacked(stacked[name], ranked[2][name])


def test_rank0_excludes_worker3s_payload_by_its_bytes(runs):
    """Only worker 3 (rank 1's) sent a NaN payload (step 1): rank 0 never drew
    worker 3, yet its parameters are finite, bitwise the stacked run's and
    the dropped twin's; worker 3's quarantine tally alone counts 1."""
    stacked, ranked = runs
    nan0, drop0 = ranked[2]["target_nan"][0], ranked[2]["target_drop"][0]
    assert {w for _, w, _ in _drawn(nan0)} == {0, 1}
    params = [k for k in nan0 if k.startswith("param/")]
    assert params
    for k in params:
        assert np.isfinite(nan0[k]).all(), k
        np.testing.assert_array_equal(nan0[k], stacked["target_nan"][k], err_msg=k)
        np.testing.assert_array_equal(nan0[k], drop0[k], err_msg=k)
    tallies = {w: float(rec[f"quarantine_total/{w}"]) for rec in ranked[2]["target_nan"]
               for w in range(W) if f"quarantine_total/{w}" in rec}
    assert tallies == {0: 0.0, 1: 0.0, 2: 0.0, 3: 1.0}
    np.testing.assert_array_equal(ranked[2]["target_drop"][1]["alive_prev/3"], 0.0)
