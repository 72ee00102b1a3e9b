"""The port's persistent cache and calibration
(``repro_torch.core.compilecache``, ``repro_torch.core.calibrate``): the
counterparts of ``tests/test_persistent_cache.py`` and what the port's
cache holds besides (the kernel libraries, each bundle class's wire
artifact).

The manifest is sound only if the shape-class keys serialize identically
across processes: ``test_key_digests_stable_across_processes`` derives the
engine's and the trainer's keys in a fresh interpreter and compares.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core import calibrate, compilecache
from repro_torch.core.calibrate import CalibrationProfile
from repro_torch.experiments.scenario import Scenario
from test_torch_sync import _one_thread, cuda  # noqa: F401  (torch on one thread)


@contextlib.contextmanager
def isolated_cache(path):
    """The persistent cache at ``path`` with zeroed counters for the body;
    the previous directory and no active profile after."""
    compilecache.cache_dir()  # read the variable first, so prev is the real one
    prev = compilecache.configure(None if path is None else str(path))
    compilecache.reset_stats()
    try:
        yield compilecache
    finally:
        compilecache.configure(prev)
        compilecache.reset_stats()
        calibrate.set_active(None)


def _cell(**kw) -> Scenario:
    base = dict(sync="bsp", n_workers=4, steps=3, compressor="qsgd",
                compressor_kwargs={"levels": 4}, error_feedback=True, lr=0.05)
    return Scenario(**{**base, **kw})


def _tiny_bundle(cache: bool = True, levels: int = 4):
    from repro_torch.experiments.trainer_substrate import make_tiny_workload, to_comm_config
    from repro_torch.optim.optimizers import momentum_sgd
    from repro_torch.train.steps import build_bundle

    comm = to_comm_config(_cell(n_workers=2, compressor_kwargs={"levels": levels}))
    cfg, shape, _ = make_tiny_workload()
    return build_bundle(cfg, comm, momentum_sgd(0.0), shape, n_workers=2, device="cpu",
                        cache=cache)


def key_reprs() -> dict:
    """The engine's and the bundle registry's keys for a fixed cell each, as
    their fresh builds hand them to ``record_compile``, with their digests."""
    from repro_torch.core.simulate import engine_cache_clear
    from repro_torch.experiments.runner import _run_training_scenarios
    from repro_torch.train.steps import bundle_cache_clear

    seen = {}
    real = compilecache.record_compile
    compilecache.record_compile = lambda kind, key: seen.setdefault(kind, key) and False
    try:
        engine_cache_clear()
        _run_training_scenarios([_cell()], device="cpu")
        bundle_cache_clear()
        _tiny_bundle()
    finally:
        compilecache.record_compile = real
        engine_cache_clear()
        bundle_cache_clear()
    out = {f"{k}_key": compilecache.stable_repr(v) for k, v in seen.items()}
    out.update({f"{k}_digest": compilecache.stable_digest(k, v) for k, v in seen.items()})
    return out


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------


def test_record_compile_miss_then_hit(tmp_path):
    with isolated_cache(tmp_path) as cc:
        key = ("bsp", 4, 8, True, "qsgd", False, "reset")
        assert cc.record_compile("engine", key) is False  # first build: miss
        assert cc.record_compile("engine", key) is True  # a later process: hit
        assert cc.record_compile("bundle", key) is False  # the kinds are disjoint
        st = cc.stats("engine")
        assert (st.hits, st.misses) == (1, 1)
        assert st.as_dict() == {"hits": 1, "misses": 1, "dir": str(tmp_path)}
        assert len(os.listdir(tmp_path / cc.MANIFEST_DIRNAME)) == 2
        # never the reference's subdirectories
        assert not {"repro-manifest", "repro-exec"} & set(os.listdir(tmp_path))


def test_unconfigured_cache_is_a_counted_nothing_noop():
    from repro_torch.kernels.build import BUILD_DIR, KernelLibrary

    with isolated_cache(None) as cc:
        assert cc.record_compile("engine", ("k",)) is False
        st = cc.stats("engine")
        assert (st.hits, st.misses) == (0, 0)
        assert st.as_dict()["dir"] is None
        assert cc.wire_path("bundle", ("k",)) is None and cc.kernels_dir() is None
        assert calibrate.default_path() is None and calibrate.load_default() is None
        # the kernels build where they always did, under the same name
        import hashlib

        from repro_torch.kernels.build import CSRC, NVCC_FLAGS

        digest = hashlib.sha1((CSRC / "qsgd.cu").read_bytes()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        assert KernelLibrary()._target("qsgd") == BUILD_DIR / f"libqsgd-{digest}.so"


def test_cache_dir_is_read_at_first_use(tmp_path, monkeypatch):
    monkeypatch.setattr(compilecache, "_DIR", None)
    monkeypatch.setattr(compilecache, "_ENV_CHECKED", False)
    monkeypatch.setenv(compilecache.ENV_VAR, str(tmp_path / "env"))
    try:
        assert compilecache.cache_dir() == str(tmp_path / "env")
        assert (tmp_path / "env" / compilecache.MANIFEST_DIRNAME).is_dir()
    finally:
        compilecache.configure(None)


def test_stats_surfaced_on_both_cache_stat_objects(tmp_path):
    from repro_torch.core.simulate import engine_cache_stats
    from repro_torch.train.steps import bundle_cache_stats

    with isolated_cache(tmp_path) as cc:
        cc.record_compile("engine", ("e",))
        cc.record_compile("bundle", ("b",))
        cc.record_compile("bundle", ("b",))
        assert engine_cache_stats().persistent_cache == {"hits": 0, "misses": 1,
                                                         "dir": str(tmp_path)}
        assert bundle_cache_stats().persistent_cache == {"hits": 1, "misses": 1,
                                                         "dir": str(tmp_path)}


def test_digest_pins_source_and_device_fingerprints(monkeypatch):
    """An edit of the port's sources, another torch, CUDA or card changes
    every digest: the key names which build a cell needs, the fingerprints
    what computed it."""
    key = ("k",)
    real = compilecache.source_fingerprint()
    assert real and real != "0" * 16
    before = compilecache.stable_digest("engine", key)
    monkeypatch.setattr(compilecache, "_SOURCE_HASH", "0" * 16)
    assert compilecache.stable_digest("engine", key) != before
    monkeypatch.setattr(compilecache, "_SOURCE_HASH", real)
    assert compilecache.cache_fingerprint("cpu")[2:] == ("cpu", "cpu", 1)
    fp = compilecache.cache_fingerprint()
    monkeypatch.setattr(compilecache, "cache_fingerprint",
                        lambda device=None: fp[:3] + ("NVIDIA H100 80GB HBM3 sm_90", 1))
    assert compilecache.stable_digest("engine", key) != before


def test_cache_false_build_never_manifested(tmp_path):
    """cache=False is the per-cell baseline: it pays the whole build and
    neither writes a wire artifact nor seeds the manifest."""
    from repro_torch.train.steps import bundle_cache_clear

    with isolated_cache(tmp_path) as cc:
        bundle_cache_clear()
        try:
            _tiny_bundle(cache=False)
            st = cc.stats("bundle")
            assert (st.hits, st.misses) == (0, 0)
            assert os.listdir(tmp_path / cc.MANIFEST_DIRNAME) == []
            assert not (tmp_path / cc.WIRE_DIRNAME).exists()
            _tiny_bundle(cache=True)
            assert (st.hits, st.misses) == (0, 1)
            assert len(os.listdir(tmp_path / cc.MANIFEST_DIRNAME)) == 1
            assert len(os.listdir(tmp_path / cc.WIRE_DIRNAME)) == 1
        finally:
            bundle_cache_clear()


def test_warm_bundle_build_loads_its_wire_artifact(tmp_path, monkeypatch):
    """A later process's build of the class loads the booked records (no
    meta-device trace) and is bitwise the fresh build's, for a cell of the
    class with other knob values too."""
    from repro_torch.train import steps
    from repro_torch.train.steps import bundle_cache_clear, bundle_cache_stats

    with isolated_cache(tmp_path) as cc:
        bundle_cache_clear()
        try:
            fresh = _tiny_bundle()
            assert (cc.stats("bundle").hits, cc.stats("bundle").misses) == (0, 1)
            bundle_cache_clear()  # a new process: nothing in memory

            def no_trace(bundle):
                raise AssertionError("a warm cache must not trace")

            monkeypatch.setattr(steps, "_book_wire", no_trace)
            warm = _tiny_bundle(levels=16)
            assert bundle_cache_stats().builds == 1
            assert bundle_cache_stats().persistent_cache["hits"] == 1
            assert warm.wire == fresh.wire and warm.wire["train"]["grad_agg"] > 0
            assert warm.logs.keys() == fresh.logs.keys()
            for name in fresh.logs:
                assert warm.logs[name].records == fresh.logs[name].records
            assert warm.comm.compressor_kwargs != fresh.comm.compressor_kwargs
        finally:
            bundle_cache_clear()


def test_kernel_libraries_live_in_the_cache_keyed_by_toolchain(tmp_path, monkeypatch):
    """Under a cache the libraries go to ``<cache>/repro-kernels/``, named
    by source, flags, nvcc release and card: a library there is reused
    (seconds 0.0, no nvcc build), one for another card never is."""
    from repro_torch.kernels import build

    h100 = "Cuda compilation tools, release 12.8, V12.8.93; NVIDIA H100 80GB HBM3 sm_90"
    with isolated_cache(tmp_path):
        monkeypatch.setattr(build, "toolchain_fingerprint", lambda: h100)
        lib = build.KernelLibrary()
        target = lib._target("qsgd")
        assert target.parent == tmp_path / compilecache.KERNELS_DIRNAME
        target.parent.mkdir(parents=True)
        target.write_bytes(b"")  # what an earlier process built
        rec = lib.build(("qsgd",))["qsgd"]
        assert (rec.path, rec.seconds) == (target, 0.0) and lib.nvcc_builds() == 0
        monkeypatch.setattr(build, "toolchain_fingerprint", lambda: h100.replace(
            "H100 80GB HBM3 sm_90", "A100-SXM4-80GB sm_80"))
        assert build.KernelLibrary()._target("qsgd") != target


def test_key_digests_stable_across_processes():
    here = key_reprs()
    assert set(here) == {"engine_key", "bundle_key", "engine_digest", "bundle_digest"}
    assert " at 0x" not in here["engine_key"] + here["bundle_key"]
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_calibrate as m; print(json.dumps(m.key_reprs()))")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, os.path.dirname(__file__)], env=env,
                         capture_output=True, text=True, check=True, timeout=240)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == here


def test_traced_sibling_hits_structural_sibling_misses(tmp_path):
    """The manifest keys at shape-class granularity: after the in-memory
    registry is dropped, a sibling differing in values (levels, lr) hits
    and one differing in structure (the sync scheme) misses."""
    from repro_torch.core.simulate import engine_cache_clear
    from repro_torch.experiments.runner import _run_training_scenarios, training_shape_key

    a, traced, structural = _cell(), _cell(compressor_kwargs={"levels": 16}, lr=0.1), \
        _cell(sync="local")
    assert training_shape_key(a) == training_shape_key(traced)
    assert training_shape_key(a) != training_shape_key(structural)
    with isolated_cache(tmp_path) as cc:
        st = cc.stats("engine")
        for cell, want in ((a, (0, 1)), (traced, (1, 1)), (structural, (1, 2))):
            engine_cache_clear()  # a fresh build asks the disk
            _run_training_scenarios([cell], device="cpu")
            assert (st.hits, st.misses) == want, cell.tag()
        engine_cache_clear()


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def test_fit_alpha_beta_recovers_exact_line_as_the_reference():
    from repro.core.calibrate import fit_alpha_beta as jfit

    alpha, beta = 3e-4, 2e-9
    xs = [1e3, 1e4, 1e5, 1e6]
    ys = [alpha + beta * x for x in xs]
    a, b = calibrate.fit_alpha_beta(xs, ys)
    assert a == pytest.approx(alpha, rel=1e-6) and b == pytest.approx(beta, rel=1e-6)
    rng = np.random.default_rng(0)
    noisy = (np.array(xs) * 1e-10 + rng.uniform(0, 1e-5, 4)).tolist()
    assert calibrate.fit_alpha_beta(xs, noisy) == jfit(xs, noisy)
    with pytest.raises(ValueError):
        calibrate.fit_alpha_beta([1.0], [1.0])


def test_fit_alpha_beta_clamps_nonnegative():
    from repro.core.calibrate import fit_alpha_beta as jfit

    # decreasing times against bytes: noise, not a negative bandwidth
    a, b = calibrate.fit_alpha_beta([1e3, 1e6], [2e-3, 1e-3])
    assert a >= 0 and b > 0
    assert (a, b) == jfit([1e3, 1e6], [2e-3, 1e-3])


def test_profile_save_load_and_active_registry(tmp_path):
    from repro_torch.core.costmodel import Link

    p = CalibrationProfile(alpha=1e-4, beta=2e-10, t_launch=5e-5, t_step_dense=0.01,
                           meta={"note": "test"})
    q = CalibrationProfile.load(p.save(str(tmp_path / "calibration.json")))
    assert q.as_dict() == p.as_dict()
    assert q.link() == Link(alpha=1e-4, beta=2e-10)
    default = Link()
    assert calibrate.set_active(q) is None
    try:
        assert calibrate.get_active() is q
        assert calibrate.active_link(default) == q.link()
        assert calibrate.active_launch() == pytest.approx(5e-5)
    finally:
        calibrate.set_active(None)
    assert calibrate.active_link(default) is default
    assert calibrate.active_launch() == 0.0


def test_profile_persists_next_to_cache_dir(tmp_path):
    with isolated_cache(tmp_path):
        path = calibrate.default_path()
        assert path == str(tmp_path / "calibration.json")
        assert calibrate.load_default() is None
        CalibrationProfile(alpha=1e-4, beta=1e-10, t_launch=1e-5, t_step_dense=None).save(path)
        got = calibrate.load_default()
        assert got is not None and got.t_step_dense is None


def test_load_default_skips_foreign_fingerprint(tmp_path):
    """A profile fitted under another fingerprint (another card count, the
    card where this process runs on the CPU) is skipped; one without a
    stored fingerprint is adopted."""
    with isolated_cache(tmp_path):
        path = calibrate.default_path()
        fp = list(compilecache.cache_fingerprint("cpu"))
        card = fp[:2] + ["cuda", "NVIDIA H100 80GB HBM3 sm_90", 1]
        for foreign in (fp[:-1] + [fp[-1] + 1], card):
            CalibrationProfile(alpha=1e-4, beta=1e-10, t_launch=1e-5, t_step_dense=None,
                               meta={"fingerprint": foreign}).save(path)
            assert calibrate.load_default("cpu") is None
        CalibrationProfile(alpha=1e-4, beta=1e-10, t_launch=1e-5, t_step_dense=None,
                           meta={"fingerprint": fp}).save(path)
        got = calibrate.load_default("cpu")
        assert got is not None and got.meta["fingerprint"] == fp


def test_predict_trainer_step_uses_calibrated_constants():
    """The data sheet (compute_time 1.0 s) without a profile; the profile's
    compute, link and launch terms with one, given or active (calibrated 0
    -> 1), as the reference's."""
    from repro.core.calibrate import CalibrationProfile as JProfile
    from repro.experiments.scenario import Scenario as JScenario
    from repro.experiments.trainer_substrate import predict_trainer_step as jpredict
    from repro_torch.experiments.trainer_substrate import predict_trainer_step

    kw_s = dict(sync="bsp", n_workers=4, steps=8, compressor="qsgd",
                compressor_kwargs={"levels": 4}, error_feedback=True)
    s, js = Scenario(**kw_s), JScenario(**kw_s)
    kw = dict(data_par=4, payload_round=1e6, n_buckets=2)
    before = predict_trainer_step(s, **kw)
    assert before["calibrated"] == 0.0 and before["step_time_s"] >= s.compute_time
    assert before == jpredict(js, **kw)
    consts = dict(alpha=1e-5, beta=1e-10, t_launch=2e-4, t_step_dense=0.004)
    prof = CalibrationProfile(**consts)
    after = predict_trainer_step(s, **kw, profile=prof)
    assert after["calibrated"] == 1.0
    expected_comm = (2 * 3 * 1e-5 + 2 * 3 / 4 * 1e-10 * 1e6) + 2e-4 * 2
    assert after["comm_time_s"] == pytest.approx(expected_comm, rel=1e-9)
    assert after["step_time_s"] == pytest.approx(0.004 + expected_comm, rel=1e-9)
    assert after == jpredict(js, **kw, profile=JProfile(**consts))
    calibrate.set_active(prof)
    try:
        assert predict_trainer_step(s, **kw) == after
    finally:
        calibrate.set_active(None)


def test_predict_overlap_saving_reads_the_active_profile():
    from repro_torch.experiments.trainer_substrate import predict_overlap_saving

    s = Scenario(sync="bsp", n_workers=2, steps=4, overlap="pipelined", microbatch=2)
    kw = dict(compute_s=0.01, payload_round=1e6, n_buckets=3, data_par=2)
    prof = CalibrationProfile(alpha=2e-5, beta=3e-10, t_launch=1e-4, t_step_dense=0.005)
    explicit = predict_overlap_saving(s, **kw, profile=prof)
    assert explicit != predict_overlap_saving(s, **kw)
    calibrate.set_active(prof)
    try:
        assert predict_overlap_saving(s, **kw) == explicit
    finally:
        calibrate.set_active(None)


def test_simulate_schedule_launch_term():
    from repro_torch.core.schedule import LayerSpec, simulate_schedule

    layers = [LayerSpec("l0", grad_bytes=1e6, backward_time=0.01),
              LayerSpec("l1", grad_bytes=1e6, backward_time=0.01)]
    base = simulate_schedule(layers, n_workers=4, mode="sequential")
    lifted = simulate_schedule(layers, n_workers=4, mode="sequential", launch=1e-3)
    # launch 0.0 is the uncalibrated model; a positive launch is charged
    # once per message
    assert lifted["total_comm_time"] == pytest.approx(
        base["total_comm_time"] + 1e-3 * base["n_messages"])


def test_calibrate_on_cpu_saves_next_to_the_cache(tmp_path):
    with isolated_cache(tmp_path):
        prof = calibrate.calibrate(steps=3, repeats=2, device="cpu",
                                   trace_dir=str(tmp_path / "trace"))
        assert prof.meta["path"] == str(tmp_path / "calibration.json")
        assert prof.meta["fingerprint"] == list(compilecache.cache_fingerprint("cpu"))
        assert len(prof.meta["sizes_bytes"]) == 5 and "booked" in prof.meta["collective"]
        assert prof.alpha > 0 and prof.beta > 0 and prof.t_launch > 0
        assert 0 < prof.t_step_dense < 60
        assert os.path.getsize(prof.meta["trace"]) > 0
        assert calibrate.load_default("cpu").as_dict()["alpha"] == prof.alpha


def _trainer_lane(tmp_path, *extra) -> dict:
    from repro_torch.experiments import run as prun
    from repro_torch.train.steps import bundle_cache_clear

    bundle_cache_clear()  # a fresh process's registry
    path = tmp_path / "trainer.json"
    assert prun.main(["--substrate", "trainer", "--device", "cpu", "--workers", "2",
                      "--steps", "2", "--grid", "sync=bsp compressor=none", "--cache-dir",
                      str(tmp_path / "cache"), "--emit-json", str(path), *extra]) == 0
    return json.loads(path.read_text())


def test_run_py_adopts_the_profile_and_calibration_none_forces_the_data_sheet(tmp_path):
    with isolated_cache(None):
        rec = _trainer_lane(tmp_path)
        assert rec["calibrated"] is False
        assert rec["cells"][0]["predicted"]["calibrated"] == 0.0
        assert rec["bundle"]["persistent_cache"]["misses"] == 1
        CalibrationProfile(alpha=1e-5, beta=1e-10, t_launch=2e-4, t_step_dense=0.004,
                           meta={"fingerprint": list(compilecache.cache_fingerprint("cpu"))}
                           ).save(str(tmp_path / "cache" / "calibration.json"))
        rec = _trainer_lane(tmp_path)
        assert rec["calibrated"] is True
        assert rec["cells"][0]["predicted"]["calibrated"] == 1.0
        assert rec["persistent_cache"]["bundle"]["dir"] == str(tmp_path / "cache")
        rec = _trainer_lane(tmp_path, "--calibration", "none")
        assert rec["calibrated"] is False
        assert rec["cells"][0]["predicted"]["calibrated"] == 0.0
        assert rec["cells"][0]["predicted"]["step_time_s"] >= 1.0  # the data sheet's


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_calibrate_on_card(cuda, tmp_path):
    with isolated_cache(tmp_path):
        prof = calibrate.calibrate(device=cuda)
        assert prof.meta["fingerprint"][2] == "cuda"
        assert 0 < prof.t_launch < 1e-2 and 0 < prof.t_step_dense < 5
        assert calibrate.load_default(cuda) is not None
        assert calibrate.load_default("cpu") is None  # a card's profile is not the CPU's


@pytest.mark.gpu
def test_coldstart_warm_cache_builds_nothing(cuda, tmp_path):
    """The coldstart twin's two layers legs: a cold cache pays every nvcc
    build, class program and wire trace; a warm one builds nothing."""
    from repro_torch.benchmarks import coldstart_bench as cb

    cold = cb.run_child(cb._LAYERS_CHILD, str(tmp_path), cuda, "cold")
    warm = cb.run_child(cb._LAYERS_CHILD, str(tmp_path), cuda, "warm")
    cb.check_legs(cold, warm)
    assert cold["nvcc_builds"] == cold["libraries"] > 0
    assert warm["nvcc_builds"] == 0
    assert warm["trainer"]["persistent"]["hits"] == warm["trainer"]["builds"] == 4
    assert warm["engine"]["persistent"]["hits"] == warm["engine"]["compiles"] == 5


def test_coldstart_datasheet_prediction_is_the_trainers_own():
    """The calibration leg's data-sheet column is what the trainer predicts
    with no profile active, for a sequential and a pipelined cell."""
    from repro_torch.benchmarks import coldstart_bench as cb
    from repro_torch.experiments.trainer_substrate import run_trainer_sweep, stacked_devices

    cells = [c.replace(steps=2) for c in cb.calibration_cells()[-2:]]
    results, skipped = run_trainer_sweep(cells, device="cpu")
    assert not skipped
    for r in results:
        assert cb.datasheet_prediction(r, stacked_devices(cells)) == r.predicted
    rel = cb.relerrs(results, [r.predicted for r in results])
    assert rel["n_cells"] == 2 and rel["step_time"] > 0 and rel["overlap_saving"] is not None
