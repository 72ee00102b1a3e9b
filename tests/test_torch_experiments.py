"""The port's sweep layer (repro_torch.experiments, the timeline simulator)
and the engine's row-batched kernel wrappers against the JAX package.

* The row wrappers on the CPU against the reference's flat ops under
  ``jax.vmap`` (Pallas interpret): per-row norms and levels; qsgd codes
  compared where the dither draw is more than 1e-5 from its threshold (the
  two norms sum in different orders, ROADMAP queue 3), terngrad codes and
  scales, packed sign bytes and unpacked signs bitwise.
* ``simulate_timeline`` (numpy in both packages) at rtol 1e-12 for every
  sync x architecture, and with churn and corruption on.
* ``run_scenarios`` and ``main(argv)`` of ``run.py``: the measured and
  predicted columns against the reference's, the training engine fed the
  reference's draws (test_torch_simulate.py's tolerances); what the
  roofline and trainer substrates still refuse.
* On a CUDA card (``gpu``): the row kernels against their plain versions,
  and the engine's launches at two batch sizes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulate as J
from repro.experiments import Scenario as JScenario
from repro.experiments import run as jrun
from repro.experiments import runner as jrunner
from repro.experiments.tables import format_table as jformat
from repro.kernels import ops as jops
from repro_torch.core import simulate as P
from repro_torch.core.compression import get_compressor as pget
from repro_torch.experiments import Scenario
from repro_torch.experiments import run as prun
from repro_torch.experiments import runner as prunner
from repro_torch.experiments.tables import format_table as pformat
from repro_torch.kernels import ops, ref
from test_torch_simulate import reference_draws
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ROW_SHAPES = [(5, 64), (3, 1000), (4, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    return torch.device("cuda")


def _rows(rows, n, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * scale).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    return x, rng.random((rows, n), dtype=np.float32)


def _levels(rows):
    return np.array([4.0, 16.0, 8.0, 127.0, 2.0][:rows] * (rows // 5 + 1), np.float32)[:rows]


def _far(a, u, norm, levels):
    y = np.abs(a.astype(np.float64)) / norm.astype(np.float64)[:, None] * levels[:, None]
    return np.abs(y - np.floor(y) - u) > 1e-5


@pytest.mark.parametrize("rows,n", ROW_SHAPES)
def test_qsgd_rows_match_the_reference_under_vmap(rows, n):
    x, u = _rows(rows, n, rows + n)
    lv = _levels(rows)
    want_c, want_n = jax.vmap(lambda a, b, s: jops.qsgd_quantize(a, b, levels=s))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(lv))
    got_c, got_n = ops.qsgd_quantize_rows(torch.from_numpy(x), torch.from_numpy(u),
                                          torch.from_numpy(lv))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n)[:, 0], rtol=1e-6)
    keep = _far(x, u, np.asarray(want_n)[:, 0], lv)
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(got_c.numpy()[keep], np.asarray(want_c)[keep])
    deq = ops.qsgd_dequantize_rows(got_c, got_n, torch.from_numpy(lv)).numpy()
    want_deq = jax.vmap(lambda c, m, s: jops.qsgd_dequantize(c, m, levels=s))(
        want_c, want_n, jnp.asarray(lv))
    np.testing.assert_allclose(deq[keep], np.asarray(want_deq)[keep], rtol=1e-6)


@pytest.mark.parametrize("rows,n", ROW_SHAPES)
def test_qsgd_ef_rows_match_the_reference_under_vmap(rows, n):
    g, u = _rows(rows, n, 2 * rows + n)
    e, _ = _rows(rows, n, 3 * rows + n, scale=0.05)
    lv = _levels(rows)
    want_c, want_n, want_e = jax.vmap(lambda a, b, c, s: jops.qsgd_ef_fused(a, b, c, levels=s))(
        jnp.asarray(g), jnp.asarray(e), jnp.asarray(u), jnp.asarray(lv))
    got_c, got_n, got_e = ops.qsgd_ef_fused_rows(torch.from_numpy(g), torch.from_numpy(e),
                                                 torch.from_numpy(u), torch.from_numpy(lv))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n)[:, 0], rtol=1e-6)
    keep = _far(e + g, u, np.asarray(want_n)[:, 0], lv)
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(got_c.numpy()[keep], np.asarray(want_c)[keep])
    np.testing.assert_allclose(got_e.numpy()[keep], np.asarray(want_e)[keep], rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("rows,n", ROW_SHAPES)
def test_terngrad_rows_match_the_reference_under_vmap(rows, n):
    x, u = _rows(rows, n, 5 * rows + n)
    want_t, want_s = jax.vmap(jops.terngrad_quantize)(jnp.asarray(x), jnp.asarray(u))
    got_t, got_s = ops.terngrad_quantize_rows(torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s)[:, 0])
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("rows,n", ROW_SHAPES + [(2, 9000)])
def test_sign_rows_match_the_reference_under_vmap(rows, n):
    x, _ = _rows(rows, n, 7 * rows + n)
    x[0, 1] = -0.0
    want = jax.vmap(jops.sign_pack)(jnp.asarray(x))
    got = ops.sign_pack_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = ops.sign_unpack_rows(got, n)
    want_back = jax.vmap(lambda p: jops.sign_unpack(p, n))(want)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want_back))


def test_row_wrappers_take_the_plain_path_on_the_cpu():
    ops.reset_launches()
    x, u = _rows(4, 64, 0)
    x, u = torch.from_numpy(x), torch.from_numpy(u)
    ops.qsgd_quantize_rows(x, u, 16)
    ops.qsgd_ef_fused_rows(x, x, u, 8)
    ops.terngrad_quantize_rows(x, u)
    ops.sign_unpack_rows(ops.sign_pack_rows(x), 64)
    assert not any(ops.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The timeline simulator.
# ---------------------------------------------------------------------------


def _timeline_equal(kw):
    want = J.simulate_timeline(J.TimelineCfg(**kw))
    got = P.simulate_timeline(P.TimelineCfg(**kw))
    np.testing.assert_allclose(got.finish_times, want.finish_times, rtol=1e-12)
    for k, v in want.row().items():
        np.testing.assert_allclose(got.row()[k], v, rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("sync", ("bsp", "ssp", "asp", "local"))
@pytest.mark.parametrize("arch", ("ps", "allreduce", "gossip"))
def test_timeline_matches_the_reference(sync, arch):
    _timeline_equal(dict(n_workers=6, iters=40, sync=sync, arch=arch, staleness=2,
                         local_steps=4, straggler_worker_slowdown=1.5, seed=1))


@pytest.mark.parametrize("sync", ("bsp", "ssp", "asp", "local"))
def test_timeline_with_churn_and_corruption_matches_the_reference(sync):
    base = dict(n_workers=6, iters=48, sync=sync, arch="ps", staleness=2, local_steps=4,
                seed=2, churn_start=4, churn_end=40)
    _timeline_equal(dict(base, dropout_rate=0.2, rejoin_policy="pull_avg"))
    _timeline_equal(dict(base, worker_dropout=(0.3, 0.0, 0.1, 0.0, 0.5, 0.0),
                         corruption_rate=0.15, corruption_kind="nan", quarantine_limit=2))
    _timeline_equal(dict(base, straggler_dist="uniform", worker_speeds=(1, 2, 1, 0.5, 1, 1),
                         corruption_rate=0.1, corruption_kind="bitflip"))


# ---------------------------------------------------------------------------
# The runner and the CLI.
# ---------------------------------------------------------------------------


def _cells(mod):
    base = dict(n_workers=4, steps=20, lr=0.05)
    return [mod(sync="bsp", compressor="qsgd", compressor_kwargs={"levels": lv},
                error_feedback=True, seed=s, **base) for lv, s in ((4, 0), (16, 1))] + \
        [mod(sync="local", local_steps=4, compressor="topk", compressor_kwargs={"ratio": 0.1},
             error_feedback=ef, **base) for ef in (False, True)]


def test_run_scenarios_training_matches_the_reference():
    want = jrunner.run_scenarios(_cells(JScenario), "training", replicas=2)
    got = prunner.run_scenarios(_cells(Scenario), "training", replicas=2, device="cpu",
                                draws=reference_draws)
    for g, w in zip(got, want):
        assert g.tag == w.tag and g.predicted == w.predicted
        for k in ("loss", "consensus"):
            np.testing.assert_allclose(g.series[k], w.series[k], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(g.series["bits"], w.series["bits"], rtol=1e-6)
        for k in ("final_loss", "consensus"):
            np.testing.assert_allclose(g.measured[k], w.measured[k], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(g.measured["gbits"], w.measured["gbits"], rtol=1e-6)
        assert abs(g.measured["x_star_err"] - w.measured["x_star_err"]) < 1e-3
    assert pformat(got).splitlines()[:2] == jformat(want).splitlines()[:2]


@pytest.mark.parametrize("substrate", ("timeline", "schedule"))
def test_run_scenarios_timeline_and_schedule_match_the_reference(substrate):
    axes = dict(sync=["bsp", "local", "asp"], arch=["ps", "allreduce"], n_workers=[8],
                steps=[30], schedule=["wfbp", "mgwfbp"], bucket_bytes=[4e6])
    from repro.experiments import expand as jexpand
    from repro_torch.experiments import expand as pexpand

    want = jrunner.run_scenarios(jexpand(dict(axes), substrate=substrate), substrate,
                                 replicas=2 if substrate == "timeline" else 1)
    got = prunner.run_scenarios(pexpand(dict(axes), substrate=substrate), substrate,
                                replicas=2 if substrate == "timeline" else 1)
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        assert g.tag == w.tag
        for k, v in w.measured.items():
            np.testing.assert_allclose(g.measured[k], v, rtol=1e-12, err_msg=k)
        for k, v in w.predicted.items():
            np.testing.assert_allclose(g.predicted[k], v, rtol=1e-12, err_msg=k)
    assert pformat(got) == jformat(want)


def _emitted(main, argv, tmp_path, name):
    path = tmp_path / f"{name}.json"
    assert main(argv + ["--emit-json", str(path), "--no-speedup"]) == 0
    return json.loads(path.read_text())


def test_main_timeline_matches_the_reference(tmp_path, capsys):
    want = _emitted(jrun.main, [], tmp_path, "ref")
    ref_out = capsys.readouterr().out
    got = _emitted(prun.main, [], tmp_path, "port")
    assert capsys.readouterr().out == ref_out
    assert got["n_cells"] == want["n_cells"] == 16
    for g, w in zip(got["cells"], want["cells"]):
        assert g["tag"] == w["tag"]
        for part in ("measured", "predicted"):
            for k, v in w[part].items():
                np.testing.assert_allclose(g[part][k], v, rtol=1e-12)


def test_main_training_matches_the_reference(tmp_path):
    """A 4-cell grid with deterministic gradients and compressors, so the two
    engines' draws do not enter."""
    argv = ["--substrate", "training", "--workers", "4", "--steps", "20", "--grid",
            "sync=bsp,local compressor=none,topk:ratio=0.1 grad_noise=0.0"]
    want = _emitted(jrun.main, argv, tmp_path, "ref")
    got = _emitted(prun.main, argv + ["--device", "cpu"], tmp_path, "port")
    assert got["n_cells"] == want["n_cells"] == 4
    assert got["engine"]["compiles"] == got["engine"]["n_shape_classes"] == 4
    for g, w in zip(got["cells"], want["cells"]):
        assert g["tag"] == w["tag"] and g["predicted"] == w["predicted"]
        for k in ("final_loss", "consensus"):
            np.testing.assert_allclose(g["measured"][k], w["measured"][k], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(g["measured"]["gbits"], w["measured"]["gbits"], rtol=1e-6)
        assert abs(g["measured"]["x_star_err"] - w["measured"]["x_star_err"]) < 1e-3


@pytest.mark.parametrize("substrate", ("roofline", "trainer"))
def test_unported_substrates_raise(substrate, tmp_path, capsys):
    """Both substrates run now (test_torch_roofline.py,
    test_torch_trainer_lane.py), and so do the reference's ``--calibration``
    and ``--cache-dir`` flags (test_torch_calibrate.py): a named profile is
    loaded as given, so a missing one raises; what the port still refuses
    raises too: an unknown flag, and on the trainer's model axis a churn
    cell (its masks per (worker, shard) are not ported)."""
    from repro_torch.core import compilecache

    prev = compilecache.cache_dir()
    with pytest.raises(FileNotFoundError):
        prun.main(["--substrate", substrate, "--cache-dir", str(tmp_path),
                   "--calibration", str(tmp_path / "missing.json")])
    with pytest.raises(SystemExit) as exc:
        prun.main(["--substrate", substrate, "--model", "2"])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
    compilecache.configure(prev)
    if substrate == "trainer":
        from repro_torch.experiments.trainer_substrate import run_trainer_scenario

        with pytest.raises(NotImplementedError, match="model axis"):
            run_trainer_scenario(Scenario(n_workers=4, steps=1, dropout_rate=0.1),
                                 model_par=2, device="cpu")
    else:
        r = prunner.run_scenarios([Scenario()], substrate)[0]
        assert r.measured["bottleneck"] in ("compute", "memory", "collective")


def test_churn_cells_raise_on_training():
    """Churn and corruption cells run on the training substrate now
    (test_torch_churn_engine.py); invalid ones raise the reference's errors,
    each naming its field."""
    with pytest.raises(ValueError, match="rejoin_policy"):
        prunner.run_scenario(Scenario(n_workers=4, steps=4, dropout_rate=0.1,
                                      rejoin_policy="bogus"), "training", device="cpu")
    with pytest.raises(ValueError, match="corruption_kind"):
        prunner.run_scenario(Scenario(n_workers=4, steps=4, corruption_rate=0.1), "training",
                             device="cpu")
    r = prunner.run_scenario(Scenario(n_workers=4, steps=4, dropout_rate=0.1, corruption_rate=0.1,
                                      corruption_kind="nan"), "training", device="cpu")
    assert {"quarantine_rounds", "quarantined_gbits", "escalations"} <= set(r.measured)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(1, 100_003), (100_003, 1), (2160, 64)])
def test_row_kernels_match_their_plain_versions(cuda, rows, n):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(rows + n)
    x = torch.randn((rows, n), generator=gen, device=cuda) * 0.1
    x.view(-1)[::7] = 0.0
    e = torch.randn((rows, n), generator=gen, device=cuda) * 0.05
    u = torch.rand((rows, n), generator=gen, device=cuda)
    lv = torch.tensor(_levels(rows), device=cuda)
    inv = torch.reciprocal(torch.clamp_min(torch.linalg.vector_norm(x, dim=-1), 1e-30))
    ops.reset_launches()
    codes = torch.empty((rows, n), dtype=torch.int8, device=cuda)
    ops.qsgd_codes_rows_into(x, u, inv, lv, codes)
    assert torch.equal(codes, ref.qsgd_codes_rows(x, u, inv, lv))
    e_new = torch.empty_like(e)
    ops.qsgd_ef_rows_into(x, e, u, inv, lv, 1.0, codes, e_new)
    want_c, want_e = ref.qsgd_ef_rows(x, e, u, inv, lv, torch.tensor(1.0, device=cuda))
    assert torch.equal(codes, want_c)
    assert bool(torch.all((e_new - want_e).abs() <= 1e-6 * want_e.abs()))
    ops.qsgd_ef_rows_into(x, e, u, inv, lv, 1.0, codes, e)  # in place
    assert bool(torch.all((e - want_e).abs() <= 1e-6 * want_e.abs()))
    inv_t = torch.reciprocal(torch.clamp_min(torch.amax(torch.abs(x), dim=-1), 1e-30))
    ops.terngrad_codes_rows_into(x, u, inv_t, codes)
    assert torch.equal(codes, ref.terngrad_codes_rows(x, u, inv_t))
    assert (ops.LAUNCHES["qsgd"], ops.LAUNCHES["qsgd_ef"], ops.LAUNCHES["terngrad"]) == (1, 2, 1)


@pytest.mark.gpu
def test_engine_launches_do_not_grow_with_the_batch(cuda):
    """A sweep of two shape classes launches each row kernel once per class
    and step, at 2 cells x 2 replicas and at 6 cells x 3 replicas."""
    counts = []
    for n_cells, replicas in ((2, 2), (6, 3)):
        ops.reset_launches()
        for sync, comp, ef in (("bsp", "qsgd_kernel", True), ("gossip", "terngrad_kernel", False)):
            cfgs = [P.SimCfg(n_workers=4, sync=sync, steps=6, lr=0.01 * (i + 1), seed=i,
                             compressor=pget(comp), error_feedback=ef) for i in range(n_cells)]
            P.simulate_training_classbatch(cfgs, P.quadratic_problem(n_workers=4, seed=0),
                                           seeds=[list(range(replicas))] * n_cells, device=cuda)
        counts.append(dict(ops.LAUNCHES))
    assert counts[0] == counts[1]
    assert counts[0]["qsgd_ef"] == 6 and counts[0]["terngrad"] == 6
