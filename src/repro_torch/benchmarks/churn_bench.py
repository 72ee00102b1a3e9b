"""Elastic workers on the port (the twin of ``benchmarks/churn_bench.py``):
fault injection, masked aggregation, rejoin and integrity on every
substrate, eight legs with the reference's assertions.

* **engine**: {static qsgd 4, static qsgd 16, adaptive_qsgd} x {0, 10,
  30%} dropout, BSP, EF, 8 workers, 250 steps, 3 replicas, every cell a
  churn cell: one class program per shape class (2), every trajectory
  finite and converging, the adaptive policy below a static one at 30%;
* **trainer**: {qsgd, adaptive_qsgd, size_adaptive} x {0, 30%} on the real
  trainer (tiny workload, 12 steps): at most one build per class, every
  other cell a hit, every loss finite;
* **rejoin** on the engine (local SGD under a windowed 30% dropout,
  ``reset`` against ``pull_avg``: one program per policy, the pull's
  download charged), on the timeline (predicted against measured resync
  events within 2x) and on the trainer (PowerSGD under churn, CHOCO and
  the masked local-SGD sync x both policies: the pull's resync channel
  at least its reset twin's);
* **integrity** on the engine ({qsgd 16, adaptive_qsgd} x {clean, 10%
  bitflip, 10% nan}: tallies booked, each within 2x of its clean twin), on
  the timeline (quarantined wire within 2x of its prediction) and on the
  trainer (measured quarantine share beside its bound).

The reference runs the trainer legs on a mesh of host devices and skips
them below two; here the workers are stacked on ``--device`` (the device
count read as the reference's cap, as ``trainer_substrate`` does) and the
legs always run.

    PYTHONPATH=src python -m repro_torch.benchmarks.churn_bench [--device cpu] [--out PATH]

The record goes to ``BENCH_torch_churn.json`` at the repository root (or
``--out``); the reference's ``BENCH_churn.json`` is never written.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import ROOT, Row, sync, table_main, write_record
from repro_torch.experiments import Scenario

BENCH_PATH = ROOT / "BENCH_torch_churn.json"

DROPOUTS = (0.0, 0.1, 0.3)
#: the policy axis: two static QSGD operating points and the variance-
#: feedback one
POLICIES = (
    ("static_qsgd4", "qsgd", {"levels": 4}),
    ("static_qsgd16", "qsgd", {"levels": 16}),
    ("adaptive_qsgd", "adaptive_qsgd", {"var_target": 0.5}),
)


def churn_matrix(*, steps: int = 250, n_workers: int = 8, seed: int = 0) -> list[Scenario]:
    """3 policies x 3 dropout rates = 9 cells, 2 engine shape classes."""
    return [Scenario(sync="bsp", n_workers=n_workers, steps=steps, lr=0.05, compressor=comp,
                     compressor_kwargs=kw, error_feedback=True, churn=True, dropout_rate=rate,
                     seed=seed)
            for _, comp, kw in POLICIES for rate in DROPOUTS]


def trainer_cells(*, steps: int = 12) -> list[Scenario]:
    """The trainer leg: {qsgd, adaptive_qsgd, size_adaptive} x {0, 30%}."""
    return [Scenario(sync="bsp", n_workers=4, steps=steps, lr=0.1, compressor=comp,
                     compressor_kwargs=kw, error_feedback=True, churn=True, dropout_rate=rate,
                     seed=0)
            for comp, kw in (("qsgd", {"levels": 16}), ("adaptive_qsgd", {"var_target": 0.5}),
                             ("size_adaptive", {"threshold": 4096}))
            for rate in (0.0, 0.3)]


def rejoin_engine_cells(*, steps: int = 200) -> list[Scenario]:
    base = dict(sync="local", local_steps=5, n_workers=8, steps=steps, lr=0.05,
                compressor="qsgd", compressor_kwargs={"levels": 16}, error_feedback=True,
                churn=True, dropout_rate=0.3, churn_start=steps // 4,
                churn_end=3 * steps // 4, seed=0)
    return [Scenario(**base, rejoin_policy="reset"), Scenario(**base, rejoin_policy="pull_avg")]


def rejoin_trainer_cells(*, steps: int = 12) -> list[Scenario]:
    """PowerSGD under churn, then CHOCO gossip and the masked local-SGD sync
    under each rejoin policy."""
    window = dict(churn=True, dropout_rate=0.3, churn_start=2, churn_end=8, seed=0)
    cells = [Scenario(sync="bsp", n_workers=4, steps=steps, lr=0.05, compressor="powersgd",
                      compressor_kwargs={"rank": 2}, error_feedback=True, **window)]
    for policy in ("reset", "pull_avg"):
        cells.append(Scenario(arch="gossip", gossip_compress="choco", n_workers=4, steps=steps,
                              lr=0.05, compressor="qsgd", compressor_kwargs={"levels": 16},
                              rejoin_policy=policy, **window))
        cells.append(Scenario(sync="local", local_steps=2, n_workers=4, steps=steps, lr=0.05,
                              compressor="qsgd", compressor_kwargs={"levels": 16},
                              error_feedback=True, rejoin_policy=policy, **window))
    return cells


def integrity_engine_cells(*, steps: int = 200) -> tuple[list[Scenario], list[tuple]]:
    cells, names = [], []
    for pname, comp, kw in (("static_qsgd16", "qsgd", {"levels": 16}),
                            ("adaptive_qsgd", "adaptive_qsgd", {"var_target": 0.5})):
        for kind in ("none", "bitflip", "nan"):
            cells.append(Scenario(
                sync="bsp", n_workers=8, steps=steps, lr=0.05, compressor=comp,
                compressor_kwargs=kw, error_feedback=True, churn=True, dropout_rate=0.0,
                corruption_rate=0.1 if kind != "none" else 0.0, corruption_kind=kind, seed=0))
            names.append((pname, kind))
    return cells, names


def _steps_to(loss: np.ndarray, target: float) -> int:
    hit = np.nonzero(loss <= target)[0]
    return int(hit[0]) if hit.size else -1


def _converges(r) -> np.ndarray:
    loss = r.series["loss"].mean(axis=0)
    assert np.isfinite(loss).all(), r.tag
    assert loss[-1] < loss[0], (r.tag, float(loss[0]), float(loss[-1]))
    return loss


def _engine_sweep(cells: list[Scenario], device) -> tuple[list, float, int]:
    from repro_torch.core.simulate import engine_cache_clear, engine_cache_stats
    from repro_torch.experiments.runner import run_scenarios

    engine_cache_clear()
    t0 = time.perf_counter()
    results = run_scenarios(cells, "training", replicas=3, device=device)
    sync(device)
    return results, time.perf_counter() - t0, engine_cache_stats().compiles


def engine_leg(device, *, steps: int = 250) -> tuple[dict, list[Row]]:
    from repro_torch.experiments.runner import training_shape_key

    cells = churn_matrix(steps=steps)
    classes = {training_shape_key(s) for s in cells}
    results, sweep_s, compiles = _engine_sweep(cells, device)
    assert compiles <= len(classes), (compiles, len(classes))

    by = {}
    it = iter(results)
    for pname, _, _ in POLICIES:
        for rate in DROPOUTS:
            r = next(it)
            _converges(r)
            by[(pname, rate)] = r
    final = {k: float(r.series["loss"].mean(axis=0)[-1]) for k, r in by.items()}
    # convergence-speed target: 1.5x the best final loss of the sweep
    target = 1.5 * min(final.values())
    cells_out = [{"policy": p, "dropout": rate, "tag": r.tag, "final_loss": final[(p, rate)],
                  "gbits": r.measured["gbits"],
                  "steps_to_target": _steps_to(r.series["loss"].mean(axis=0), target)}
                 for (p, rate), r in by.items()]
    # the headline: under 30% dropout the variance-feedback policy beats at
    # least one static operating point on final loss
    adaptive = final[("adaptive_qsgd", 0.3)]
    statics = [final[(p, 0.3)] for p in ("static_qsgd4", "static_qsgd16")]
    assert adaptive < max(statics), (adaptive, statics)
    record = {"n_cells": len(cells), "n_shape_classes": len(classes), "compiles": compiles,
              "steps": cells[0].steps, "n_workers": cells[0].n_workers, "replicas": 3,
              "sweep_wall_clock_s": sweep_s, "loss_target": target,
              "adaptive_final_loss_at_30pct": adaptive,
              "static_final_losses_at_30pct": statics, "cells": cells_out}
    rows = [Row("churn/engine_sweep", sweep_s * 1e6,
                f"{len(cells)} cells -> {len(classes)} classes, {compiles} compiles"),
            Row("churn/adaptive_vs_static_30pct", 0.0,
                f"adaptive={adaptive:.4g} statics={[round(x, 4) for x in statics]}")]
    return record, rows


def _trainer_sweep(cells: list[Scenario], device, *, data_par: int | None = None):
    from repro_torch.experiments.trainer_substrate import (
        run_trainer_sweep,
        select_trainer_device_count,
        stacked_devices,
        trainer_shape_key,
    )
    from repro_torch.train.steps import bundle_cache_clear, bundle_cache_stats

    ndev = stacked_devices(cells)
    classes = {trainer_shape_key(s, data_par=data_par or
                                 select_trainer_device_count(s, ndev)[0]) for s in cells}
    bundle_cache_clear()
    t0 = time.perf_counter()
    results, skipped = run_trainer_sweep(cells, n_devices=ndev, data_par=data_par,
                                         device=device)
    sync(device)
    sweep_s = time.perf_counter() - t0
    assert not skipped, skipped
    st = bundle_cache_stats()
    assert st.builds <= len(classes), (st, len(classes))
    for r in results:
        assert np.isfinite(r.series["loss_full"]).all(), r.tag
    return results, classes, st, ndev, sweep_s


def trainer_leg(device, *, steps: int = 12) -> tuple[dict, list[Row]]:
    cells = trainer_cells(steps=steps)
    results, classes, st, ndev, sweep_s = _trainer_sweep(cells, device)
    assert st.hits == len(cells) - st.builds, st
    record = {"n_cells": len(cells), "n_shape_classes": len(classes), "builds": st.builds,
              "cache_hits": st.hits, "n_devices_stacked": ndev, "sweep_wall_clock_s": sweep_s,
              "cells": [{"tag": r.tag, "measured": dict(r.measured)} for r in results]}
    rows = [Row("churn/trainer_sweep", sweep_s * 1e6,
                f"{len(cells)} cells -> {len(classes)} classes, "
                f"{st.builds} builds ({st.hits} hits)")]
    return record, rows


def rejoin_engine_leg(device, *, steps: int = 200) -> tuple[dict, list[Row]]:
    """reset against pull_avg on the engine: both converge, the policy is
    structural (one program each), the pull's download is charged."""
    cells = rejoin_engine_cells(steps=steps)
    results, sweep_s, compiles = _engine_sweep(cells, device)
    assert compiles == 2, compiles
    out = {}
    for r in results:
        loss = _converges(r)
        out[r.scenario.rejoin_policy] = {"tag": r.tag, "final_loss": float(loss[-1]),
                                         "gbits": r.measured["gbits"]}
    assert out["pull_avg"]["gbits"] > out["reset"]["gbits"], out
    record = {"steps": steps, "dropout": 0.3, "window": [steps // 4, 3 * steps // 4],
              "compiles": compiles, "sweep_wall_clock_s": sweep_s, "policies": out}
    rows = [Row("churn/rejoin_engine", sweep_s * 1e6,
                "reset={:.4g} pull_avg={:.4g} (final loss, 2 compiles)".format(
                    out["reset"]["final_loss"], out["pull_avg"]["final_loss"]))]
    return record, rows


def rejoin_timeline_leg() -> tuple[dict, list[Row]]:
    """Predicted against measured resync overhead on the timeline."""
    from repro_torch.experiments.runner import predict, run_scenario

    base = dict(sync="bsp", n_workers=8, steps=120, compute_time=0.01, churn=True,
                dropout_rate=0.2, churn_start=20, churn_end=90, seed=0)
    record = {}
    keys = ("resync_events", "resync_seconds", "resync_bytes")
    for policy in ("reset", "pull_avg"):
        s = Scenario(**base, rejoin_policy=policy)
        m, p = run_scenario(s, "timeline").measured, predict(s, "timeline")
        assert m["resync_events"] > 0, policy
        # one sampled stream against the closed-form expectation: within 2x
        assert 0.5 < p["resync_events"] / m["resync_events"] < 2.0, (p, m)
        record[policy] = {"measured": {k: m[k] for k in keys},
                          "predicted": {k: p[k] for k in keys}}
    assert record["reset"]["measured"]["resync_bytes"] == 0.0
    assert (record["pull_avg"]["measured"]["resync_seconds"]
            > record["reset"]["measured"]["resync_seconds"])
    rows = [Row("churn/rejoin_timeline", 0.0,
                "events measured={:.0f} predicted={:.1f}".format(
                    record["pull_avg"]["measured"]["resync_events"],
                    record["pull_avg"]["predicted"]["resync_events"]))]
    return record, rows


def rejoin_trainer_leg(device, *, steps: int = 12) -> tuple[dict, list[Row]]:
    """The three formerly rejected trainer combinations under windowed
    churn, W = 4 stacked."""
    cells = rejoin_trainer_cells(steps=steps)
    dp = min(4, max(s.n_workers for s in cells))
    results, classes, st, ndev, sweep_s = _trainer_sweep(cells, device, data_par=dp)
    cells_out = []
    for r in results:
        m = r.measured
        for key in ("live_fraction", "wire_kb_per_step_alive", "wire_resync_kb_per_step"):
            assert key in m, (r.tag, key)
        cells_out.append({"tag": r.tag, "final_loss": m["final_loss"],
                          "live_fraction": m["live_fraction"],
                          "wire_kb_per_step": m["wire_kb_per_step"],
                          "wire_kb_per_step_alive": m["wire_kb_per_step_alive"],
                          "wire_resync_kb_per_step": m["wire_resync_kb_per_step"]})
    # the dense pull shows on the wire: each pull_avg cell's resync channel
    # books at least its reset twin's bytes
    by_tag = {c["tag"]: c for c in cells_out}
    for pull_tag, c in by_tag.items():
        if "+rejoin=pull_avg" in pull_tag:
            reset = by_tag[pull_tag.replace("+rejoin=pull_avg", "")]
            assert c["wire_resync_kb_per_step"] >= reset["wire_resync_kb_per_step"], by_tag
    record = {"n_cells": len(cells), "n_shape_classes": len(classes), "builds": st.builds,
              "n_devices_stacked": ndev, "data_par": dp, "sweep_wall_clock_s": sweep_s,
              "cells": cells_out}
    rows = [Row("churn/rejoin_trainer", sweep_s * 1e6,
                f"{len(cells)} formerly-rejected cells -> {len(classes)} classes, "
                f"{st.builds} builds")]
    return record, rows


def integrity_engine_leg(device, *, steps: int = 200) -> tuple[dict, list[Row]]:
    """{static qsgd16, adaptive_qsgd} x {clean, 10% bitflip, 10% nan} on
    the engine: guarded cells finite and converging, tallies booked, each
    within 2x of its policy's clean twin."""
    cells, names = integrity_engine_cells(steps=steps)
    results, sweep_s, compiles = _engine_sweep(cells, device)
    # the corruption kind is structural, the rate a value
    assert compiles <= len(cells), compiles
    out = {}
    for (pname, kind), r in zip(names, results):
        loss = _converges(r)
        entry = {"tag": r.tag, "final_loss": float(loss[-1]), "gbits": r.measured["gbits"]}
        if kind != "none":
            assert r.measured["quarantine_rounds"] > 0, r.tag
            assert r.measured["quarantined_gbits"] > 0, r.tag
            entry.update(quarantine_rounds=r.measured["quarantine_rounds"],
                         quarantined_gbits=r.measured["quarantined_gbits"],
                         escalations=r.measured["escalations"])
        out[f"{pname}/{kind}"] = entry
    for pname in ("static_qsgd16", "adaptive_qsgd"):
        clean = out[f"{pname}/none"]["final_loss"]
        for kind in ("bitflip", "nan"):
            hot = out[f"{pname}/{kind}"]["final_loss"]
            assert hot <= 2.0 * clean + 1e-6, (pname, kind, hot, clean)
    record = {"steps": steps, "corruption_rate": 0.1, "compiles": compiles,
              "sweep_wall_clock_s": sweep_s, "cells": out}
    rows = [Row("churn/integrity_engine", sweep_s * 1e6,
                "adaptive/bitflip quarantined {:.0f} rounds ({:.3g} gbits undelivered)".format(
                    out["adaptive_qsgd/bitflip"]["quarantine_rounds"],
                    out["adaptive_qsgd/bitflip"]["quarantined_gbits"]))]
    return record, rows


def integrity_timeline_leg() -> tuple[dict, list[Row]]:
    """Predicted against measured quarantined wire on the timeline."""
    from repro_torch.experiments.runner import predict, run_scenario

    s = Scenario(sync="bsp", n_workers=8, steps=120, compute_time=0.01, corruption_rate=0.1,
                 corruption_kind="bitflip", quarantine_limit=3, seed=0)
    m, p = run_scenario(s, "timeline").measured, predict(s, "timeline")
    assert m["quarantine_events"] > 0
    assert m["quarantined_bytes"] > 0
    assert 0.5 < p["quarantine_events"] / m["quarantine_events"] < 2.0, (p, m)
    record = {"measured": {k: m[k] for k in ("quarantine_events", "quarantined_bytes",
                                             "escalation_events")},
              "predicted": {k: p[k] for k in ("quarantine_events", "quarantined_bytes")}}
    rows = [Row("churn/integrity_timeline", 0.0,
                "quarantined wire measured={:.0f} predicted={:.1f} events".format(
                    m["quarantine_events"], p["quarantine_events"]))]
    return record, rows


def integrity_trainer_cell(*, steps: int = 12) -> Scenario:
    return Scenario(sync="bsp", n_workers=4, steps=steps, lr=0.05, compressor="qsgd",
                    compressor_kwargs={"levels": 16}, error_feedback=True,
                    corruption_rate=0.1, corruption_kind="bitflip", seed=0)


def integrity_trainer_leg(device, *, steps: int = 12) -> tuple[dict, list[Row]]:
    """10% bitflip on the trainer, W = 4 stacked: the measured quarantine
    share beside the closed-form bound."""
    from repro_torch.experiments.trainer_substrate import run_trainer_scenario

    s = integrity_trainer_cell(steps=steps)
    dp = s.n_workers
    t0 = time.perf_counter()
    r = run_trainer_scenario(s, data_par=dp, device=device)
    sync(device)
    sweep_s = time.perf_counter() - t0
    assert np.isfinite(r.series["loss_full"]).all()
    m, p = r.measured, r.predicted
    record = {"data_par": dp, "sweep_wall_clock_s": sweep_s, "tag": r.tag,
              "measured": {k: m[k] for k in ("quarantine_rounds", "escalations",
                                             "quarantine_fraction",
                                             "wire_kb_per_step_quarantined")},
              "predicted": {k: p[k] for k in ("quarantine_fraction",
                                              "wire_kb_per_step_quarantined")}}
    rows = [Row("churn/integrity_trainer", sweep_s * 1e6,
                "quarantine_fraction measured={:.3f} predicted<={:.3f}".format(
                    m["quarantine_fraction"], p["quarantine_fraction"]))]
    return record, rows


def run(device: str | torch.device = "cuda", out: str | None = None) -> list[Row]:
    device = torch.device(device)
    engine_rec, rows = engine_leg(device)
    legs = {}
    for name, leg in (("trainer", lambda: trainer_leg(device)),
                      ("rejoin_engine", lambda: rejoin_engine_leg(device)),
                      ("rejoin_timeline", rejoin_timeline_leg),
                      ("rejoin_trainer", lambda: rejoin_trainer_leg(device)),
                      ("integrity_engine", lambda: integrity_engine_leg(device)),
                      ("integrity_timeline", integrity_timeline_leg),
                      ("integrity_trainer", lambda: integrity_trainer_leg(device))):
        legs[name], leg_rows = leg()
        rows += leg_rows
    write_record({"engine": engine_rec, "trainer": legs["trainer"],
                  "rejoin": {k: legs["rejoin_" + k] for k in ("engine", "timeline", "trainer")},
                  "integrity": {k: legs["integrity_" + k]
                                for k in ("engine", "timeline", "trainer")}},
                 out, BENCH_PATH, device)
    rows.append(Row("churn/claims_validated", 0.0, True))
    return rows


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
