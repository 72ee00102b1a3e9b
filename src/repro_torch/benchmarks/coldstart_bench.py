"""Cold start of the port: the persistent cache and the calibration (the
twin of ``benchmarks/coldstart_bench.py``).

Every number that matters here is a cold-process number, so each leg runs
in a subprocess that imports only ``repro_torch`` and configures the cache
(:mod:`repro_torch.core.compilecache`) at one shared directory, as the
reference's legs do:

* **cold process, cold cache**: a fresh interpreter and an empty
  directory, so it pays what a first process pays: the ``nvcc``
  builds of every kernel source on the card, then the engine's first sweep (its class programs)
  and the trainer's (the meta-device wire traces of its bundle classes);
* **cold process, warm cache**: a fresh interpreter on the same
  directory: every kernel library is reused (no ``nvcc``) and every shape
  class is a persistent hit (the trainer's wire artifacts loaded, no
  trace);
* **warm process**: each layer's second sweep inside the warm-cache
  process, the in-memory registries' bound, for scale.

The layers are the engine's 90-cell sweep (``sweep_matrix_45`` x 2 problem
seeds, 20 steps) and the trainer's 16-cell matrix (``trainer_matrix_16``,
6 steps unless ``run``'s ``trainer_steps`` says otherwise, W = 4
stacked).  One card serves both, so one process runs both layers of a
leg (the reference forces another device count for each).  The reference
asserts its warm-cache trainer sweep >= 3x faster than the
cold one, a bill of XLA compiles; the port compiles no XLA, and what a
warm cache saves it is ``nvcc`` and the wire traces, a small share of a
sweep whose steps dominate.  So the port's acceptance is that the
warm-cache leg builds nothing (0 ``nvcc`` builds, 0 persistent misses,
every class a persistent hit); the wall ratios are recorded.

The calibration leg fits the device's profile (:mod:`repro_torch.core.
calibrate`: the stacked all-reduce ladder, launch overhead, the dense
step) in a third subprocess and runs the trainer matrix and an overlap
twin pair once, each cell's measured step time held against both
predictions, the data sheet's and the fitted profile's: the mean
step-time rel-err must strictly improve (asserted, as in the reference,
which runs the sweep twice to the same end); the overlap saving's is
recorded.

    PYTHONPATH=src python -m repro_torch.benchmarks.coldstart_bench [--device cpu] [--out PATH]

The record goes to ``BENCH_torch_coldstart.json`` at the repository root
(or ``--out``); the reference's ``BENCH_coldstart.json`` is never written.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from repro_torch.benchmarks.common import ROOT, Row, table_main, write_record

BENCH_PATH = ROOT / "BENCH_torch_coldstart.json"

ENGINE_STEPS = 20
TRAINER_STEPS = 6

#: every child starts the same way: the cache at COLDSTART_CACHE, then,
#: on the card, every kernel library (nvcc on a cold cache)
_PRELUDE = """
import json, os, time
from repro_torch.core import compilecache
compilecache.configure(os.environ["COLDSTART_CACHE"])
from repro_torch.kernels.build import LIBRARY
dev = os.environ["COLDSTART_DEVICE"]
t0 = time.perf_counter()
if dev.startswith("cuda"):
    LIBRARY.build()
build = {"build_s": time.perf_counter() - t0, "nvcc_builds": LIBRARY.nvcc_builds(),
         "libraries": len(LIBRARY.records)}
"""

_LAYERS_CHILD = _PRELUDE + f"""
import torch
from repro_torch.core.simulate import engine_cache_stats
from repro_torch.experiments.runner import _run_training_scenarios, _sync, sweep_matrix_45
from repro_torch.experiments.trainer_substrate import run_trainer_sweep, trainer_matrix_16
from repro_torch.train.steps import bundle_cache_stats
warm = os.environ["COLDSTART_LEG"] == "warm"
engine_cells = sweep_matrix_45(steps={ENGINE_STEPS}, problem_seeds=(0, 1))
trainer_cells = trainer_matrix_16(steps=int(os.environ["COLDSTART_TRAINER_STEPS"]))

def engine():
    _run_training_scenarios(engine_cells, replicas=1, device=dev)

def trainer():
    assert not run_trainer_sweep(trainer_cells, device=dev)[1]

def timed(fn):
    t0 = time.perf_counter(); fn(); _sync(torch.device(dev))
    return time.perf_counter() - t0

out = dict(build)
for name, fn, cells in (("engine", engine, engine_cells), ("trainer", trainer, trainer_cells)):
    out[name] = {{"n_cells": len(cells), "first_s": timed(fn)}}
    if warm:  # the second sweep: the in-memory registry's bound
        out[name]["warm_process_s"] = timed(fn)
st = engine_cache_stats()
out["engine"].update(compiles=st.compiles, persistent=st.persistent_cache)
st = bundle_cache_stats()
out["trainer"].update(builds=st.builds, hits=st.hits, persistent=st.persistent_cache)
print("RESULT " + json.dumps(out))
"""

_CALIBRATE_CHILD = _PRELUDE + """
from repro_torch.benchmarks.coldstart_bench import calibration_leg
print("RESULT " + json.dumps({**build, **calibration_leg(
    dev, int(os.environ["COLDSTART_TRAINER_STEPS"]))}))
"""


def calibration_cells(steps: int = TRAINER_STEPS) -> list:
    """The trainer matrix and an overlap twin pair (sequential, pipelined),
    ``steps`` steps each."""
    from repro_torch.experiments.scenario import Scenario
    from repro_torch.experiments.trainer_substrate import trainer_matrix_16

    return trainer_matrix_16(steps=steps) + [
        Scenario(sync="bsp", n_workers=4, steps=steps, lr=0.05, compressor="qsgd",
                 compressor_kwargs={"levels": 16}, overlap=overlap, microbatch=2)
        for overlap in ("sequential", "pipelined")]


def datasheet_prediction(r, n_devices: int) -> dict:
    """What ``run_trainer_scenario`` predicts for the cell of result ``r``
    with no profile active: the data sheet's step time and, for a pipelined
    cell, overlap saving (from the cell's measured step, as there)."""
    from repro_torch.core import aggregate, calibrate
    from repro_torch.experiments import trainer_substrate as ts
    from repro_torch.models import transformer as T

    s = r.scenario
    dp = ts.select_trainer_device_count(s, n_devices)[0]
    plan = aggregate.make_bucket_plan(ts.to_comm_config(s),
                                      T.param_defs(ts.make_tiny_workload()[0]))
    kw = dict(data_par=dp, payload_round=ts.plan_payload_bytes(plan),
              n_buckets=len(plan.buckets))
    prev = calibrate.set_active(None)
    try:
        pred = ts.predict_trainer_step(s, **kw)
        if s.overlap == "pipelined":
            pred.update(ts.predict_overlap_saving(s, compute_s=r.measured["step_time_s"], **kw))
    finally:
        calibrate.set_active(prev)
    return pred


def relerrs(results: list, predicted: list[dict]) -> dict:
    """Mean relative error of the predicted step time (and overlap saving,
    where a cell has both) against the measured one."""
    step, save = [], []
    for r, p in zip(results, predicted):
        m = r.measured
        step.append(abs(p["step_time_s"] - m["step_time_s"]) / m["step_time_s"])
        if "overlap_saving_s" in m and "overlap_saving_s" in p:
            save.append(abs(p["overlap_saving_s"] - m["overlap_saving_s"])
                        / max(abs(m["overlap_saving_s"]), 1e-9))

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    return {"step_time": mean(step), "overlap_saving": mean(save), "n_cells": len(step)}


def calibration_leg(device, steps: int = TRAINER_STEPS) -> dict:
    """Fit the profile (saved next to the cache), run the calibration cells
    once with it active, and hold each cell's measured step time against
    the fitted profile's prediction and the data sheet's."""
    from repro_torch.core import calibrate
    from repro_torch.experiments.trainer_substrate import run_trainer_sweep, stacked_devices

    profile = calibrate.calibrate(steps=steps, device=device)
    cells = calibration_cells(steps)
    prev = calibrate.set_active(profile)
    try:
        results, skipped = run_trainer_sweep(cells, device=device)
    finally:
        calibrate.set_active(prev)
    assert not skipped, skipped
    before = [datasheet_prediction(r, stacked_devices(cells)) for r in results]
    return {"profile": profile.as_dict(), "before": relerrs(results, before),
            "after": relerrs(results, [r.predicted for r in results])}


def run_child(code: str, cache_dir: str, device: torch.device, leg: str = "cold", *,
              timeout: int = 900, trainer_steps: int = TRAINER_STEPS) -> dict:
    """Run one leg in a fresh interpreter that imports only ``repro_torch``
    from this checkout, with its cache at ``cache_dir``, the trainer's
    cells ``trainer_steps`` steps each; its RESULT line."""
    env = dict(os.environ)
    env["COLDSTART_TRAINER_STEPS"] = str(trainer_steps)
    env["COLDSTART_CACHE"] = cache_dir
    env["COLDSTART_LEG"] = leg
    env["COLDSTART_DEVICE"] = str(device)
    env.pop("REPRO_TORCH_CACHE_DIR", None)  # the child configures explicitly
    src = str(ROOT / "src")
    env["PYTHONPATH"] = os.pathsep.join([src] + ([env["PYTHONPATH"]]
                                                 if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"coldstart child failed:\n{out.stderr[-4000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def check_legs(cold: dict, warm: dict) -> None:
    """The port's acceptance: the cold cache misses every class it builds,
    the warm cache builds nothing (no nvcc, no miss) and hits every class."""
    assert warm["nvcc_builds"] == 0, warm
    for layer, built in (("engine", "compiles"), ("trainer", "builds")):
        c, w = cold[layer], warm[layer]
        assert c["persistent"]["misses"] == c[built], cold
        assert w["persistent"]["misses"] == 0, warm
        assert w["persistent"]["hits"] == w[built], warm


def _layer(cold: dict, warm: dict, layer: str, steps: int, built: str) -> dict:
    c, w = cold[layer], warm[layer]
    return {"n_cells": c["n_cells"], "steps": steps, built: c[built],
            "cold_cache_s": c["first_s"], "warm_cache_s": w["first_s"],
            "warm_process_s": w["warm_process_s"],
            "disk_speedup": c["first_s"] / w["first_s"],
            "persistent_cold": c["persistent"], "persistent_warm": w["persistent"]}


def measure(device: torch.device, trainer_steps: int = TRAINER_STEPS) -> dict:
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="coldstart-cache-") as cache_dir:
        cold, warm, cal = (run_child(code, cache_dir, device, leg, trainer_steps=trainer_steps)
                           for code, leg in ((_LAYERS_CHILD, "cold"), (_LAYERS_CHILD, "warm"),
                                             (_CALIBRATE_CHILD, "cold")))
    check_legs(cold, warm)
    if device.type == "cuda":
        assert cold["nvcc_builds"] == cold["libraries"] == warm["libraries"] > 0, (cold, warm)
    # calibration strictly improves the step-time prediction; the overlap
    # saving's rel-err is recorded, not asserted
    rel_before, rel_after = cal["before"]["step_time"], cal["after"]["step_time"]
    assert rel_after < rel_before, cal
    cold_total = cold["build_s"] + cold["engine"]["first_s"] + cold["trainer"]["first_s"]
    warm_total = warm["build_s"] + warm["engine"]["first_s"] + warm["trainer"]["first_s"]
    trainer = _layer(cold, warm, "trainer", trainer_steps, "builds")
    trainer["cache_hits"] = cold["trainer"]["hits"]
    return {
        "start": {"cold_build_s": cold["build_s"], "warm_build_s": warm["build_s"],
                  "nvcc_builds_cold": cold["nvcc_builds"], "nvcc_builds_warm": warm["nvcc_builds"],
                  "libraries": warm["libraries"],
                  "wall_ratio_with_build": cold_total / warm_total},
        "engine": _layer(cold, warm, "engine", ENGINE_STEPS, "compiles"),
        "trainer": trainer,
        "calibration": {
            "profile": cal["profile"],
            "relerr_step_time_before": rel_before,
            "relerr_step_time_after": rel_after,
            "relerr_overlap_saving_before": cal["before"]["overlap_saving"],
            "relerr_overlap_saving_after": cal["after"]["overlap_saving"],
            "n_cells": cal["before"]["n_cells"],
        },
        "bench_wall_clock_s": time.perf_counter() - t_all,
    }


def run(device: str | torch.device = "cuda", out: str | None = None,
        trainer_steps: int = TRAINER_STEPS) -> list[Row]:
    device = torch.device(device)
    rec = measure(device, trainer_steps)
    write_record(rec, out, BENCH_PATH, device)
    st, eng, tr, cal = rec["start"], rec["engine"], rec["trainer"], rec["calibration"]
    return [
        Row("coldstart/build", st["warm_build_s"] * 1e6,
            f"cold {st['cold_build_s']:.1f}s ({st['nvcc_builds_cold']} nvcc builds) -> warm "
            f"{st['warm_build_s']:.1f}s ({st['nvcc_builds_warm']}); start to both sweeps "
            f"x{st['wall_ratio_with_build']:.2f}"),
        Row("coldstart/engine_disk", eng["warm_cache_s"] * 1e6,
            f"cold {eng['cold_cache_s']:.1f}s -> warm-disk {eng['warm_cache_s']:.1f}s "
            f"({eng['disk_speedup']:.2f}x, {eng['compiles']} programs)"),
        Row("coldstart/trainer_disk", tr["warm_cache_s"] * 1e6,
            f"cold {tr['cold_cache_s']:.1f}s -> warm-disk {tr['warm_cache_s']:.1f}s "
            f"({tr['disk_speedup']:.2f}x, {tr['builds']} bundles, warm misses "
            f"{tr['persistent_warm']['misses']})"),
        Row("coldstart/calibration", 0.0,
            f"step-time rel-err {cal['relerr_step_time_before']:.2f} -> "
            f"{cal['relerr_step_time_after']:.2f} (alpha={cal['profile']['alpha']:.2e}, "
            f"beta={cal['profile']['beta']:.2e})"),
        Row("coldstart/claims_validated", 0.0, True),
    ]


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
