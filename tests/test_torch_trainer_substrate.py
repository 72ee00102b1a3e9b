"""The pure functions of the port's trainer substrate
(``repro_torch.experiments.trainer_substrate``) against the reference's, on
a scenario list that covers BSP, local, post-local, pod-local, gossip
(D-PSGD and CHOCO), pipelined (staleness 1 and 0), churn, per-worker
dropout and corruption cells:

* ``to_comm_config``: every CommConfig field equal;
* ``select_trainer_device_count`` for 1-8 devices, microbatch 1, 2 and 4;
* ``sync_rounds`` over 0-13 steps, ``expected_live_fraction``,
  ``expected_quarantine_fraction``, the wire figures of a booked artifact
  and ``plan_payload_bytes`` of each compressor's plan: equal;
* ``predict_trainer_step`` and ``predict_overlap_saving`` at rtol 1e-12,
  with the data-sheet constants and with a calibration profile;
* the ``trainer_shape_key`` partition of ``trainer_matrix_16``,
  ``trainer_matrix_8``, the overlap benchmark's matrix, the three
  examples' cells and the list above equals the reference's, and the port's
  twins declare the reference's cells.
"""

import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.aggregate import make_bucket_plan as jmake_bucket_plan
from repro.core.costmodel import Link as JLink
from repro.experiments import Scenario as JScenario
from repro.experiments import trainer_substrate as J
from repro_torch.core.aggregate import make_bucket_plan
from repro_torch.core.costmodel import Link
from repro_torch.core.types import CommConfig
from repro_torch.experiments import Scenario
from repro_torch.experiments import trainer_substrate as P
from repro_torch.models.transformer import param_defs
from test_torch_sync import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(n_workers=4, steps=12, lr=0.05)
Q16 = dict(compressor="qsgd", compressor_kwargs={"levels": 16})
QK_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
             wire_format="compressed", error_feedback=True)
#: name -> Scenario fields (on top of BASE)
CELLS = {
    "bsp_qsgd_ef": dict(error_feedback=True, **Q16),
    "local": dict(sync="local", local_steps=4),
    "post_local": dict(sync="post_local", post_local_switch=3, local_steps=4, **QK_EF),
    "pod_local": dict(pod_local=True, local_steps=2, compressor="terngrad"),
    "gossip": dict(arch="gossip"),
    "choco": dict(arch="gossip", gossip_compress="choco", compressor="topk",
                  compressor_kwargs={"ratio": 0.1}),
    "pipelined": dict(overlap="pipelined", microbatch=4, **Q16),
    "pipelined_s0": dict(overlap="pipelined", overlap_staleness=0, microbatch=2),
    "churn": dict(dropout_rate=0.3, churn_start=2, churn_end=8, **QK_EF),
    "churn_pull_gossip": dict(arch="gossip", dropout_rate=0.2, rejoin_policy="pull_avg"),
    "worker_dropout": dict(worker_dropout=(0.0, 0.1, 0.2, 0.5)),
    "corrupt": dict(compressor="terngrad_kernel", wire_format="compressed",
                    error_feedback=True, corruption_rate=0.1, corruption_kind="bitflip"),
    "corrupt_local": dict(sync="local", local_steps=2, dropout_rate=0.1, corruption_rate=0.2,
                          corruption_kind="nan", churn_start=1),
    "corrupt_pipelined": dict(overlap="pipelined", microbatch=2, corruption_rate=0.2,
                              corruption_kind="spike", **Q16),
    "sign_cwire": dict(compressor="signsgd_packed", wire_format="compressed"),
    "bucketed_topk": dict(bucket_bytes=0.25e6, compressor="topk",
                          compressor_kwargs={"ratio": 0.05}, error_feedback=True),
}
NAMES = list(CELLS)


def _pair(name):
    kw = dict(BASE, **CELLS[name])
    return Scenario(**kw), JScenario(**kw)


def _comm_fields(c) -> dict:
    out = dataclasses.asdict(c)
    out["compressor_kwargs"] = dict(out["compressor_kwargs"])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_to_comm_config_matches_reference(name):
    s, js = _pair(name)
    assert s.violations("trainer") == js.violations("trainer") == []
    got, want = _comm_fields(P.to_comm_config(s)), _comm_fields(J.to_comm_config(js))
    assert set(got) == set(want)
    assert got == want


def test_to_comm_config_refuses_what_the_reference_refuses():
    for kw in (dict(sync="asp"), dict(arch="ps"), dict(arch="gossip", corruption_rate=0.1,
                                                        corruption_kind="nan")):
        s, js = Scenario(**BASE, **kw), JScenario(**BASE, **kw)
        assert s.violations("trainer") == js.violations("trainer") != []
        with pytest.raises(ValueError, match="cannot run on the trainer"):
            P.to_comm_config(s)


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_select_trainer_device_count_matches_reference(n_devices):
    for name in NAMES:
        for mb in (1, 2, 4):
            for workers in (2, 3, 4, 8):
                kw = dict(CELLS[name], microbatch=mb)
                if "worker_dropout" in kw:
                    kw["worker_dropout"] = tuple(0.1 * i for i in range(workers))
                s, js = (Scenario(**dict(BASE, n_workers=workers, **kw)),
                         JScenario(**dict(BASE, n_workers=workers, **kw)))
                assert (P.select_trainer_device_count(s, n_devices)
                        == J.select_trainer_device_count(js, n_devices)), (name, mb, workers)


@pytest.mark.parametrize("name", NAMES)
def test_counts_and_fractions_match_reference(name):
    for steps in range(14):
        s, js = (Scenario(**dict(BASE, **CELLS[name], steps=steps)),
                 JScenario(**dict(BASE, **CELLS[name], steps=steps)))
        assert P.sync_rounds(s, steps) == J.sync_rounds(js, steps)
        assert P.expected_live_fraction(s) == J.expected_live_fraction(js)
        assert P.expected_quarantine_fraction(s) == J.expected_quarantine_fraction(js)


#: a booked artifact with every program and tag the wire figures read
WIRE = {"train": {"grad_agg": 1234.5, "zero1_gather": 7.0},
        "sync": {"local_sgd_sync": 4321.25, "churn_resync": 17.5},
        "gossip": {"gossip_mix": 999.0, "churn_resync": 33.0},
        "train_formats": {"f32": 1000.0, "int8": 234.5},
        "gossip_formats": {"f32": 999.0}}


@pytest.mark.parametrize("name", NAMES)
def test_wire_figures_match_reference(name):
    s, js = _pair(name)
    for wire in (WIRE, {}, {"train": {"grad_agg": 10.0}}):
        assert P.trainer_wire_per_step(s, wire) == J.trainer_wire_per_step(js, wire)
        assert P.trainer_wire_resync_per_step(s, wire) == J.trainer_wire_resync_per_step(js, wire)
        assert P.trainer_wire_formats(s, wire) == J.trainer_wire_formats(js, wire)


@pytest.mark.parametrize("comp,kw", [
    ("none", {}), ("qsgd", {"levels": 16}), ("qsgd_kernel", {"levels": 4}),
    ("terngrad", {}), ("signsgd_packed", {}), ("topk", {"ratio": 0.05}),
    ("threshold", {"tau": 1e-3}), ("powersgd", {"rank": 4}), ("natural", {})])
def test_plan_payload_bytes_matches_reference(comp, kw):
    """Each compressor's analytic payload over the tiny workload's plan,
    per tensor and in 0.25 MB buckets (NaN sizes charged dense)."""
    from repro.core.types import CommConfig as JCommConfig

    cfg = P.make_tiny_workload()[0]
    for bucket_mb in (0.0, 0.25):
        c = dict(compressor=comp, compressor_kwargs=kw, bucket_mb=bucket_mb)
        plan = make_bucket_plan(CommConfig(**c), param_defs(cfg))
        jplan = jmake_bucket_plan(JCommConfig(**c), param_defs(cfg))
        assert P.plan_payload_bytes(plan) == J.plan_payload_bytes(jplan) > 0


class _Profile:
    """A calibration profile's interface (the reference's
    ``CalibrationProfile``: ``link()``, ``t_launch``, ``t_step_dense``)."""

    def __init__(self, link_cls, t_step_dense):
        self._link = link_cls(alpha=3e-5, beta=2e-10)
        self.t_launch, self.t_step_dense = 4e-6, t_step_dense

    def link(self):
        return self._link


@pytest.mark.parametrize("name", NAMES)
def test_predictions_match_reference(name):
    s, js = _pair(name)
    for dp in (2, 4, 8):
        for payload, nb in ((1.5e6, 24), (3.2e4, 1), (7.7e7, 13)):
            want = J.predict_trainer_step(js, data_par=dp, payload_round=payload, n_buckets=nb)
            got = P.predict_trainer_step(s, data_par=dp, payload_round=payload, n_buckets=nb)
            assert got.keys() == want.keys() and got["calibrated"] == 0.0
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
            for t_dense in (None, 0.25):
                want = J.predict_trainer_step(js, data_par=dp, payload_round=payload,
                                              n_buckets=nb, profile=_Profile(JLink, t_dense))
                got = P.predict_trainer_step(s, data_par=dp, payload_round=payload,
                                             n_buckets=nb, profile=_Profile(Link, t_dense))
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
            for compute in (0.05, 1.3):
                kw = dict(compute_s=compute, payload_round=payload, n_buckets=nb, data_par=dp)
                want = J.predict_overlap_saving(js, **kw)
                got = P.predict_overlap_saving(s, **kw)
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
                # the profile's link and launch against the reference's
                # explicit arguments
                want = J.predict_overlap_saving(js, link=JLink(alpha=3e-5, beta=2e-10),
                                                launch=4e-6, **kw)
                got = P.predict_overlap_saving(s, profile=_Profile(Link, None), **kw)
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)


def _partition(keys: list) -> list[tuple[int, ...]]:
    groups: dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return sorted(tuple(g) for g in groups.values())


def _reference_module(relpath: str, name: str):
    """A reference benchmark or example loaded from its file, leaving the
    environment (its XLA_FLAGS) and the path as they were."""
    env, path = dict(os.environ), list(sys.path)
    sys.path.insert(0, str(ROOT))
    try:
        spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path


def _matrices():
    from repro_torch.benchmarks import overlap_bench
    from repro_torch.examples import compression_comparison, gossip_decentralized
    from repro_torch.examples import local_sgd_vs_bsp

    jov = _reference_module("benchmarks/overlap_bench.py", "_ref_overlap_bench")
    jex = {n: _reference_module(f"examples/{n}.py", f"_ref_{n}")
           for n in ("local_sgd_vs_bsp", "gossip_decentralized", "compression_comparison")}
    return {
        "trainer_matrix_16": (P.trainer_matrix_16(), J.trainer_matrix_16(), None),
        "trainer_matrix_8": (P.trainer_matrix_8(steps=3), J.trainer_matrix_8(steps=3), 4),
        "overlap": (overlap_bench.overlap_matrix(), jov.overlap_matrix(), None),
        "local_sgd_vs_bsp": ([s for _, s in local_sgd_vs_bsp.RUNS],
                             [s for _, s in jex["local_sgd_vs_bsp"].RUNS], None),
        "gossip_decentralized": ([s for _, s in gossip_decentralized.RUNS],
                                 [s for _, s in jex["gossip_decentralized"].RUNS], None),
        "compression_comparison": ([s for _, s in compression_comparison.CELLS],
                                   [s for _, s in jex["compression_comparison"].CELLS], 4),
        "cells": ([_pair(n)[0] for n in NAMES], [_pair(n)[1] for n in NAMES], None),
    }


def test_shape_key_partitions_match_reference():
    matrices = _matrices()
    for name, (port, ref, dp) in matrices.items():
        assert [dataclasses.asdict(s) for s in port] == [dataclasses.asdict(s) for s in ref], name
        got = _partition([P.trainer_shape_key(s, data_par=dp) for s in port])
        want = _partition([J.trainer_shape_key(s, data_par=dp) for s in ref])
        assert got == want, name
    assert len(_partition([P.trainer_shape_key(s) for s in P.trainer_matrix_16()])) == 4
    # the overlap matrix's 14 cells in 12 classes: its siblings share one
    assert len(_partition([P.trainer_shape_key(s) for s in matrices["overlap"][0]])) == 12
