"""The port's engine-side benchmark twins against the reference's modules:
``convergence`` (its twelve cells through the port's engine on the
reference's replayed draws, at the engine's tolerances: series rtol 2e-4 /
atol 1e-5, bits rtol 1e-6, x_star_err within 1e-3, and within rtol 0.2 on
the qsgd_kernel EF cell, whose final iterate a dither code an ulp apart
decorrelates after 400 steps; the section's claims and the BSP rate
fit), ``sweep`` (the class count and one program per class),
``churn_bench`` (every leg's grid equal to the reference's, every leg's
assertions at reduced steps) and ``kernels_bench`` (its byte model
equal to ``BENCH_kernels.json``; on the card, every kernel launched and
each fused output against its composed one).  No reference ``run()`` that
writes a record is called: the grids, functions and constants are
compared instead.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import churn_bench, convergence, kernels_bench, sweep
from test_torch_simulate import reference_draws
from test_torch_sync import _one_thread, cuda  # noqa: F401  (torch on one thread)

ROOT = Path(__file__).resolve().parents[1]


def _fields(s) -> dict:
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}


def _same_cells(got, want):
    assert [_fields(s) for s in got] == [_fields(s) for s in want]
    assert [s.tag() for s in got] == [s.tag() for s in want]


def test_convergence_cells_match_the_reference():
    from benchmarks import convergence as ref
    from repro.experiments import run_scenarios as jrun_scenarios

    _same_cells(convergence.CELLS, ref.CELLS)
    assert convergence.BASE == ref.BASE
    want = jrun_scenarios(ref.CELLS, "training")
    got = convergence.cells("cpu", draws=reference_draws)
    errs = {}
    for g, w in zip(got, want):
        assert g.tag == w.tag and g.predicted == w.predicted
        for k in ("loss", "consensus"):
            np.testing.assert_allclose(g.series[k], w.series[k], rtol=2e-4, atol=1e-5,
                                       err_msg=f"{g.tag}/{k}")
        np.testing.assert_allclose(g.series["bits"], w.series["bits"], rtol=1e-6)
        if g.scenario.compressor == "qsgd_kernel":
            # an EF trajectory through a dithered quantizer: one code an ulp
            # apart decorrelates the final iterate while the loss and
            # consensus series stay within tolerance (PERF.md, PR 20)
            np.testing.assert_allclose(g.measured["x_star_err"], w.measured["x_star_err"],
                                       rtol=0.2)
        else:
            assert abs(g.measured["x_star_err"] - w.measured["x_star_err"]) < 1e-3, g.tag
        s = g.scenario
        errs[(s.sync, s.arch, s.compressor)] = g.measured["x_star_err"]
    # the section's claims hold on the port's numbers
    assert errs[("bsp", "allreduce", None)] <= errs[("asp", "ps", None)] + 0.05
    assert errs[("bsp", "allreduce", None)] <= errs[("local", "allreduce", None)] + 0.05


def test_convergence_run_writes_its_record(tmp_path):
    rows = convergence.run("cpu", str(tmp_path / "c.json"), no_speedup=True)
    names = [r.name for r in rows]
    assert names[-1] == "convergence/rate_exponent_bsp" and len(names) == 14
    assert "convergence/claims_validated" in names
    rec = json.loads((tmp_path / "c.json").read_text())
    assert len(rec["cells"]) == 12 and rec["rate_exponent_bsp"] > 0
    loss = np.linspace(10.0, 1.0, 600) ** -1.0 + 1.0
    assert convergence.rate_exponent(loss) == pytest.approx(
        -np.polyfit(np.log(np.arange(40, 300)),
                    np.log(np.maximum(loss[40:300] - loss[-1], 1e-9)), 1)[0])


def test_sweep_builds_one_program_per_class(tmp_path):
    from repro.experiments.runner import sweep_matrix_45 as jmatrix
    from repro.experiments.runner import training_shape_key as jkey
    from repro_torch.experiments.runner import sweep_matrix_45, training_shape_key

    cells = sweep_matrix_45(problem_seeds=(0, 1))
    _same_cells(cells, jmatrix(problem_seeds=(0, 1)))
    n_classes = len({training_shape_key(s) for s in cells})
    assert n_classes == len({jkey(s) for s in jmatrix(problem_seeds=(0, 1))}) == 5
    rows = sweep.run("cpu", str(tmp_path / "s.json"), no_speedup=True)
    assert rows[-1].name == "sweep/claims_validated"
    rec = json.loads((tmp_path / "s.json").read_text())
    assert (rec["n_cells"], rec["n_shape_classes"], rec["compiles_batched"]) == (90, 5, 5)
    assert rec["replicas"] == 3 and "percell_s" not in rec


def test_churn_grids_match_the_reference():
    import benchmarks.churn_bench as ref

    assert churn_bench.DROPOUTS == ref.DROPOUTS and churn_bench.POLICIES == ref.POLICIES
    _same_cells(churn_bench.churn_matrix(), ref.churn_matrix())
    _same_cells(churn_bench.churn_matrix(steps=40), ref.churn_matrix(steps=40))


@pytest.mark.parametrize("leg", ["engine", "rejoin_engine", "integrity_engine"])
def test_churn_engine_legs_at_reduced_steps(leg):
    fn = getattr(churn_bench, f"{leg}_leg")
    record, rows = fn("cpu", steps=120)
    assert rows and rows[0].name.startswith("churn/")
    if leg == "engine":
        assert (record["n_cells"], record["n_shape_classes"], record["compiles"]) == (9, 2, 2)
    elif leg == "rejoin_engine":
        assert record["compiles"] == 2 and record["window"] == [30, 90]
    else:
        assert set(record["cells"]) == {f"{p}/{k}" for p in ("static_qsgd16", "adaptive_qsgd")
                                        for k in ("none", "bitflip", "nan")}


def test_churn_timeline_legs():
    for fn in (churn_bench.rejoin_timeline_leg, churn_bench.integrity_timeline_leg):
        record, rows = fn()
        assert rows[0].us_per_call == 0.0 and record


@pytest.mark.parametrize("leg", ["trainer", "rejoin_trainer", "integrity_trainer"])
def test_churn_trainer_legs_at_reduced_steps(leg):
    """The reference skips these below two devices; the port stacks W = 4
    on one device and always runs them."""
    record, rows = getattr(churn_bench, f"{leg}_leg")("cpu", steps=4)
    if leg == "trainer":
        assert (record["n_cells"], record["n_shape_classes"]) == (6, 3)
        assert record["builds"] + record["cache_hits"] == 6
        assert record["n_devices_stacked"] == 4
    elif leg == "rejoin_trainer":
        assert record["n_cells"] == 5 and record["data_par"] == 4
        assert record["builds"] <= record["n_shape_classes"]
    else:
        assert record["data_par"] == 4
        assert record["measured"]["quarantine_fraction"] >= 0.0


def test_kernels_byte_model_equals_the_reference_record(tmp_path):
    ref = json.loads((ROOT / "BENCH_kernels.json").read_text())
    assert (kernels_bench.N, kernels_bench.W) == (ref["n"], ref["workers"])
    rows = kernels_bench.run("cpu", str(tmp_path / "k.json"), sizes=(kernels_bench.N,))
    got = json.loads((tmp_path / "k.json").read_text())
    for name, fam in ref["families"].items():
        for k in ("fused_bytes", "composed_bytes"):
            assert got["families"][name][k] == fam[k], (name, k)
    assert got["families"]["sign_vote"]["bitwise_equal"] is True
    assert got["qsgd_levels_resweep"]["recompiles"] == 0
    want_names = [r["name"] for r in ref["rows"]]
    assert set(want_names) <= {r.name for r in rows}


@pytest.mark.gpu
def test_kernels_bench_on_card(cuda, tmp_path):
    """At N = 262,144 on the card: every kernel launches, sign_vote's fused
    output equals the composed one bitwise, the others within f32 rounding
    of theirs (sums in another order)."""
    from repro_torch.kernels import ops

    kernels_bench.run(cuda, str(tmp_path / "k.json"), sizes=(kernels_bench.N,))
    rec = json.loads((tmp_path / "k.json").read_text())
    assert all(v > 0 for v in rec["launches"].values()), rec["launches"]
    assert set(rec["launches"]) == set(ops.LAUNCHES)
    fams = kernels_bench.families(kernels_bench.inputs(kernels_bench.N, cuda))
    assert rec["families"]["sign_vote"]["max_abs_diff"] == 0.0
    for name, fam in fams.items():
        f = kernels_bench._flat(fam["fused"][0](*fam["fused"][1]))
        c = kernels_bench._flat(fam["composed"][0](*fam["composed"][1]))
        if name == "qsgd_ef":  # codes bitwise but where the dither gap is an ulp
            assert (f[0] != c[0]).float().mean() < 1e-4
            torch.testing.assert_close(f[1], c[1], rtol=1e-6, atol=0)
            continue
        for a, b in zip(f, c):
            torch.testing.assert_close(a.float(), b.float(), rtol=1e-5, atol=1e-6)
        assert rec["families"][name]["fused_gb_per_s"] > 0
