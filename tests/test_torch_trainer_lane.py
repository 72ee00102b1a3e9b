"""The port's trainer substrate end to end against the reference's, and its
bundle registry.

* ``run_trainer_sweep(trainer_matrix_8(steps=3), data_par=4)`` on the CPU
  against the reference's on a 4-device mesh (one subprocess for the
  module, started first and read last): both sides start from the
  reference's initial parameters, and the noise and churn hooks replay its
  key chain.  Losses within rtol 1e-4; ``wire_kb_per_step``,
  ``wire_format_kb`` and ``sync_rounds`` equal.  One corruption cell
  (``terngrad_kernel`` on the 2-bit wire under 60% bitflip,
  ``quarantine_limit`` 2): its ``quarantine_rounds`` and ``escalations``
  equal.
* The registry: a sweep of the matrix builds once per shape class; each
  cell's loss series through a shared build is bitwise that of a fresh
  build; the ``levels=8`` sibling of the ``levels=16`` cell is a registry
  hit, bitwise its own fresh build and apart from the ``levels=16`` cell
  (a shared build that kept the first cell's knobs would run both alike).
* ``run_trainer_sweep`` refuses the model axis, naming ROADMAP.
* On the card (gpu-marked): one cell through the kernels against the CPU at
  rtol 1e-5, and the smoke runs of the benchmark and example twins.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.aggregate import make_bucket_plan
from repro_torch.experiments import Scenario
from repro_torch.experiments import trainer_substrate as P
from repro_torch.kernels import ops
from repro_torch.models.transformer import param_defs
from repro_torch.train.steps import bundle_cache_clear, bundle_cache_stats
from test_torch_churn_trainer import churn_draws
from test_torch_sync import W, _noise, _one_thread, _reference_params, cuda  # noqa: F401

STEPS = 3
CORRUPT = dict(n_workers=W, steps=4, lr=0.05, compressor="terngrad_kernel",
               wire_format="compressed", error_feedback=True, corruption_rate=0.6,
               corruption_kind="bitflip", quarantine_limit=2)

REFERENCE = r"""
import json
from repro.experiments import Scenario
from repro.experiments.trainer_substrate import (run_trainer_scenario, run_trainer_sweep,
                                                 trainer_matrix_8)
CORRUPT = json.loads('CORRUPT_JSON')
res, _ = run_trainer_sweep(trainer_matrix_8(steps=STEPS), data_par=4)
out = {"matrix": [{"tag": r.tag, "loss": [float(x) for x in r.series["loss_full"]],
                   "wire_kb": r.measured["wire_kb_per_step"],
                   "formats": r.measured["wire_format_kb"],
                   "sync_rounds": r.measured["sync_rounds"]} for r in res]}
r = run_trainer_scenario(Scenario(**CORRUPT), data_par=4)
out["corrupt"] = {k: r.measured[k] for k in ("quarantine_rounds", "escalations",
                                              "wire_kb_per_step")}
out["corrupt"]["loss"] = [float(x) for x in r.series["loss_full"]]
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """The reference's run in a subprocess with W host devices, started
    before the module's tests so that it runs beside the port's."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    script = (REFERENCE.replace("CORRUPT_JSON", json.dumps(CORRUPT))
              .replace("STEPS", str(STEPS)))
    proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(_reference_run):
    out, err = _reference_run.communicate(timeout=600)
    assert _reference_run.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return json.loads(out.split("REF ", 1)[1])


def _sweep(cache: bool = True, cells=None):
    """The matrix (or ``cells``) from the reference's parameters and draws."""
    return P.run_trainer_sweep(cells or P.trainer_matrix_8(steps=STEPS), data_par=W,
                               device="cpu", bundle_cache=cache,
                               params=_reference_params(P.make_tiny_workload()[0], "cpu"),
                               noise=_noise, churn_draws=churn_draws)[0]


@pytest.fixture(scope="module")
def shared():
    """The matrix through the registry, from an empty one: the builds and
    hits it made, and the results."""
    bundle_cache_clear()
    res = _sweep()
    st = bundle_cache_stats()
    return (st.builds, st.hits), res


def test_one_build_per_class_and_cached_builds_are_bitwise_fresh_ones(shared):
    (builds, hits), res = shared
    classes = {P.trainer_shape_key(s, data_par=W) for s in P.trainer_matrix_8(steps=STEPS)}
    assert (builds, hits) == (len(classes), 8 - len(classes)) == (4, 4)
    fresh = _sweep(cache=False)
    for a, b in zip(res, fresh):
        assert np.array_equal(a.series["loss_full"], b.series["loss_full"]), a.tag
        assert a.measured["wire_kb_per_step"] == b.measured["wire_kb_per_step"]
        assert a.measured["wire_format_kb"] == b.measured["wire_format_kb"]


def test_no_value_knob_leaks_between_the_cells_of_a_class():
    base = Scenario(n_workers=W, steps=STEPS, lr=0.1, compressor="qsgd",
                    compressor_kwargs={"levels": 16}, error_feedback=True)
    sib = base.replace(compressor_kwargs={"levels": 8})
    assert P.trainer_shape_key(base) == P.trainer_shape_key(sib)
    bundle_cache_clear()
    l16, l8 = _sweep(cells=[base, sib])
    assert (bundle_cache_stats().builds, bundle_cache_stats().hits) == (1, 1)
    (f8,) = _sweep(cache=False, cells=[sib])
    assert np.array_equal(l8.series["loss_full"], f8.series["loss_full"])
    assert not np.array_equal(l8.series["loss_full"], l16.series["loss_full"])


def test_matrix_matches_reference(shared, reference):
    res = shared[1]
    assert [r.tag for r in res] == [c["tag"] for c in reference["matrix"]]
    for r, want in zip(res, reference["matrix"]):
        np.testing.assert_allclose(r.series["loss_full"], want["loss"], rtol=1e-4,
                                   err_msg=r.tag)
        assert r.measured["wire_kb_per_step"] == want["wire_kb"], r.tag
        assert r.measured["wire_format_kb"] == want["formats"], r.tag
        assert r.measured["sync_rounds"] == want["sync_rounds"], r.tag


def test_corruption_tallies_match_reference(reference):
    r = P.run_trainer_scenario(Scenario(**CORRUPT), data_par=W, device="cpu",
                               params=_reference_params(P.make_tiny_workload()[0], "cpu"),
                               noise=_noise, churn_draws=churn_draws)
    want = reference["corrupt"]
    assert want["quarantine_rounds"] > 0
    assert r.measured["quarantine_rounds"] == want["quarantine_rounds"]
    assert r.measured["escalations"] == want["escalations"]
    assert r.measured["wire_kb_per_step"] == want["wire_kb_per_step"]
    np.testing.assert_allclose(r.series["loss_full"], want["loss"], rtol=1e-4)


def test_model_axis_is_refused():
    """The sweep runs on the model axis (test_torch_model_axis_trainer.py
    holds it to the reference); what it still refuses there is a churn
    cell."""
    with pytest.raises(NotImplementedError, match="model axis"):
        P.run_trainer_sweep([Scenario(n_workers=W, steps=1, dropout_rate=0.1)], data_par=W,
                            model_par=2, device="cpu")


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_lane_cell_on_card_matches_cpu(cuda):
    """A kernel cell (qsgd_kernel on the int8 wire with EF) on the card
    against the CPU from the same weights and draws: losses within rtol
    1e-5; the kernels launch once per worker and bucket (qsgd_ef) and once
    per bucket (int8_acc) each step."""
    s = Scenario(n_workers=W, steps=STEPS, lr=0.1, compressor="qsgd_kernel",
                 compressor_kwargs={"levels": 16}, wire_format="compressed",
                 error_feedback=True)
    cfg = P.make_tiny_workload()[0]
    ops.reset_launches()
    on_card = P.run_trainer_scenario(s, data_par=W, device=cuda,
                                     params=_reference_params(cfg, cuda),
                                     noise=lambda *a: _noise(*a).to(cuda))
    launches = dict(ops.LAUNCHES)
    on_cpu = P.run_trainer_scenario(s, data_par=W, device="cpu",
                                    params=_reference_params(cfg, "cpu"), noise=_noise)
    nb = len(make_bucket_plan(P.to_comm_config(s), param_defs(cfg)).buckets)
    assert launches["qsgd_ef"] == nb * W * STEPS and launches["int8_acc"] == nb * STEPS, launches
    np.testing.assert_allclose(on_card.series["loss_full"], on_cpu.series["loss_full"],
                               rtol=1e-5)


@pytest.mark.gpu
def test_benchmark_twins_on_card(cuda, tmp_path):
    from repro_torch.benchmarks import overlap_bench, train_micro

    for mod, name in ((train_micro, "trainer"), (overlap_bench, "overlap")):
        out = tmp_path / f"{name}.json"
        rows = mod.run(cuda, str(out))
        assert rows[-1].derived is True
        rec = json.loads(out.read_text())
        assert rec["device"] == str(cuda) and rec["card"] == torch.cuda.get_device_name(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name,ok", [("local_sgd_vs_bsp", "LOCAL-SGD OK"),
                                     ("gossip_decentralized", "GOSSIP OK"),
                                     ("compression_comparison", "COMPARISON OK")])
def test_example_twins_on_card(cuda, capsys, name, ok):
    import importlib

    importlib.import_module(f"repro_torch.examples.{name}").main(["--device", "cuda"])
    assert capsys.readouterr().out.rstrip().endswith(ok)
