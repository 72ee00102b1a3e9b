"""Batch execution of scenario lists on the simulation substrates (the
port's counterpart of ``repro.experiments.runner``).

Every run returns a :class:`ScenarioResult` carrying both the measured
metrics of the substrate and the analytic cost-model prediction
(``repro_torch.core.costmodel``) for the same cell, so sweep tables show
predicted against measured side by side.

Substrates:

* ``timeline`` -- :func:`repro_torch.core.simulate.simulate_timeline`
  (Fig. 4 / Table II: throughput, staleness, idle share, wire bytes under
  stragglers), numpy;
* ``training`` -- :func:`repro_torch.core.simulate.simulate_training_classbatch`
  (section VIII: loss, consensus, upload bits) on the card: the runner
  groups cells into shape classes (:func:`training_shape_key`) and runs
  each class, times its replica seeds and workers, as one batch through one
  class program;
* ``schedule`` -- :func:`repro_torch.core.schedule.simulate_schedule`
  (section VII WFBP / MG-WFBP iteration-time model);
* ``roofline`` -- :func:`roofline_row`, the analytic compute / memory /
  collective terms of :mod:`repro_torch.launch.roofline` (H100 constants);
* ``trainer`` -- :mod:`repro_torch.experiments.trainer_substrate`, the
  cells through the real trainer on the tiny workload, W workers stacked on
  one device, grouped by trainer shape class.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.costmodel import (
    Link,
    allreduce_cost,
    gossip_cost,
    ps_cost,
    round_wire_bytes,
    upload_bits,
)
from repro_torch.core.schedule import LayerSpec, simulate_schedule
from repro_torch.core.simulate import (
    PROBLEMS,
    SimCfg,
    TimelineCfg,
    engine_cache_clear,
    engine_cache_stats,
    shape_class_key,
    simulate_timeline,
    simulate_training_batch,
    simulate_training_classbatch,
    simulate_training_reference,
)
from repro_torch.experiments.scenario import Scenario


@dataclass
class ScenarioResult:
    """One scenario executed on one substrate (replica-averaged)."""

    scenario: Scenario
    substrate: str
    measured: dict[str, float]
    predicted: dict[str, float]
    replicas: int = 1
    series: dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def tag(self) -> str:
        return self.scenario.tag()

    def row(self) -> dict[str, Any]:
        out: dict[str, Any] = {"tag": self.tag, "substrate": self.substrate}
        out.update({f"measured_{k}": v for k, v in self.measured.items()})
        out.update({f"predicted_{k}": v for k, v in self.predicted.items()})
        return out


# ---------------------------------------------------------------------------
# Cost-model predictions (the "predicted" half of every result row).
# ---------------------------------------------------------------------------


#: registry-name -> Table IV compression family for the analytic bit model.
_QUANT_BITS = {
    "qsgd": lambda kw: math.log2(kw.get("levels", 16)) + 1,
    "natural": lambda kw: 9.0,
    "natural_dithering": lambda kw: 9.0,
    "terngrad": lambda kw: math.log2(3) + 1,
    "signsgd": lambda kw: 1.0,
    "signsgd_packed": lambda kw: 1.0,
    "onebit": lambda kw: 1.0,
}
_SPARSE = ("topk", "gtopk", "randomk", "stc", "sbc", "wangni", "threshold")


def estimated_wire_bytes(s: Scenario) -> float:
    """Effective bytes ONE worker uploads per communication round.

    Prefers the real compressor's analytic ``wire_bits``; falls back to the
    Table IV family model when the size is data-dependent (NaN).
    """
    n_elems = int(s.msg_bytes / 4)  # dense f32 elements
    if s.compressor is None:
        return s.msg_bytes
    comp = s.make_compressor()
    wb = comp.wire_bits(n_elems)
    if wb == wb:  # not NaN
        return wb / 8.0
    kw = s.kwargs_dict
    if s.compressor in _QUANT_BITS:
        return upload_bits("quant", n_elems, levels=int(2 ** (_QUANT_BITS[s.compressor](kw) - 1))) / 8.0
    if any(s.compressor.startswith(p) for p in _SPARSE):
        return upload_bits("spars", n_elems, ratio=kw.get("ratio", 0.01)) / 8.0
    return s.msg_bytes


def rounds_per_iter(s: Scenario) -> float:
    """Communication rounds per iteration under the sync scheme."""
    return 1.0 / s.local_steps if s.sync == "local" else 1.0


def _round_comm_time(s: Scenario, nbytes: float) -> float:
    link = Link(alpha=s.alpha, beta=s.beta)
    if s.arch == "ps":
        return ps_cost(s.n_workers, nbytes, link, congested=s.ps_congested)
    if s.arch == "allreduce":
        return allreduce_cost(s.allreduce_alg, s.n_workers, nbytes, link)
    if s.arch == "gossip":
        return gossip_cost(nbytes, peers=s.gossip_peers, link=link)
    raise ValueError(s.arch)


def _round_wire_bytes(s: Scenario, nbytes: float) -> float:
    return round_wire_bytes(s.arch, s.n_workers, nbytes, peers=s.gossip_peers)


def predict(s: Scenario, substrate: str) -> dict[str, float]:
    """Analytic cost-model prediction for the cell, keyed to match the
    substrate's measured metrics."""
    eff = estimated_wire_bytes(s)
    rounds = rounds_per_iter(s)
    comm_per_iter = _round_comm_time(s, eff) * rounds
    if substrate == "timeline":
        # straggler-free alpha-beta estimate; the simulator adds the
        # straggler/congestion dynamics on top.
        iter_time = s.compute_time + comm_per_iter
        out = {
            "iter_time": iter_time,
            "throughput": s.n_workers / iter_time,
            "comm_frac": comm_per_iter / iter_time,
            "bytes_per_worker": _round_wire_bytes(s, eff) * rounds * s.steps,
        }
        if s.churn:
            # expected churn overhead from the Bernoulli event stream the
            # timeline simulator draws: a rejoin at step t needs dead(t-1)
            # AND alive(t) — p(1-p) per in-window step pair, plus one
            # certain-alive transition when the window closes mid-run.
            start = min(max(s.churn_start, 0), s.steps)
            end = s.steps if s.churn_end == -1 else min(s.churn_end, s.steps)
            w = max(0, end - start)
            rates = (list(s.worker_dropout) if s.worker_dropout
                     else [s.dropout_rate] * s.n_workers)
            ev = sum(max(0, w - 1) * p * (1.0 - p)
                     + (p if end < s.steps and w > 0 else 0.0)
                     for p in rates)
            per_event_s = (s.alpha + s.beta * eff
                           if s.rejoin_policy == "pull_avg" else s.alpha)
            per_event_b = eff if s.rejoin_policy == "pull_avg" else 0.0
            out["resync_events"] = ev
            out["resync_seconds"] = per_event_s * ev
            out["resync_bytes"] = per_event_b * ev
            if s.corruption_rate > 0:
                # Bernoulli corruption over the live set in the same window:
                # each live worker's wire round is quarantined w.p. rate, and
                # the quarantined bytes moved but were booked undelivered.
                live = sum(1.0 - p for p in rates)
                qe = s.corruption_rate * live * w * rounds
                out["quarantine_events"] = qe
                out["quarantined_bytes"] = _round_wire_bytes(s, eff) * qe
        return out
    if substrate == "training":
        dim_bits = 32.0 * (eff / s.msg_bytes)  # effective bits per element
        return {
            "bits_per_element": dim_bits,
            "compression_x": s.msg_bytes / eff,
            "comm_time_per_step": comm_per_iter,
        }
    if substrate == "schedule":
        layers = layer_profile(s.layer_profile)
        link = Link(alpha=s.alpha, beta=s.beta)
        bwd = sum(l.backward_time for l in layers)
        per_layer = sum(
            allreduce_cost(s.allreduce_alg, s.n_workers, l.grad_bytes, link) for l in layers
        )
        return {
            "no_overlap_time": bwd + per_layer,
            "full_overlap_bound": max(bwd, per_layer),
        }
    if substrate == "roofline":
        # the alpha-beta counterpart of the roofline terms: compute and
        # communication in series
        return {
            "iter_time": s.compute_time + comm_per_iter,
            "comm_frac": comm_per_iter / (s.compute_time + comm_per_iter),
        }
    raise ValueError(substrate)


# ---------------------------------------------------------------------------
# Layer profiles for the schedule substrate (shared with benchmarks).
# ---------------------------------------------------------------------------


def _resnet50_profile() -> list[LayerSpec]:
    # 161 gradient tensors, mostly small — the MG-WFBP motivation.
    layers = [
        LayerSpec(f"conv{i}", grad_bytes=25.5e6 * 4 / 160, backward_time=5e-3 / 160)
        for i in range(160)
    ]
    layers.append(LayerSpec("fc", grad_bytes=8e6, backward_time=5e-4))
    return layers


def _transformer32_profile() -> list[LayerSpec]:
    return [
        LayerSpec(f"block{i}", grad_bytes=12 * 4096 * 4096 * 2, backward_time=3e-3)
        for i in range(32)
    ]


def _uniform16_profile() -> list[LayerSpec]:
    return [
        LayerSpec(f"layer{i}", grad_bytes=4e6, backward_time=1e-3) for i in range(16)
    ]


LAYER_PROFILES = {
    "resnet50": _resnet50_profile,
    "transformer32": _transformer32_profile,
    "uniform16": _uniform16_profile,
}


def layer_profile(name: str) -> list[LayerSpec]:
    if name not in LAYER_PROFILES:
        raise KeyError(f"unknown layer profile {name!r}; known: {sorted(LAYER_PROFILES)}")
    return LAYER_PROFILES[name]()


# ---------------------------------------------------------------------------
# Substrate mappings.
# ---------------------------------------------------------------------------


def to_timeline_cfg(s: Scenario, seed: int | None = None) -> TimelineCfg:
    return TimelineCfg(
        n_workers=s.n_workers,
        iters=s.steps,
        compute_mean=s.compute_time,
        straggler_sigma=s.straggler_sigma,
        straggler_worker_slowdown=s.straggler_slowdown,
        alpha=s.alpha,
        beta=s.beta,
        msg_bytes=estimated_wire_bytes(s),
        server_bw_share=s.ps_congested,
        sync=s.sync,
        staleness=s.staleness,
        local_steps=s.local_steps,
        arch=s.arch,
        seed=s.seed if seed is None else seed,
        worker_speeds=s.worker_speeds,
        straggler_dist=s.straggler_dist,
        dropout_rate=s.dropout_rate,
        worker_dropout=s.worker_dropout,
        churn_start=s.churn_start,
        churn_end=s.churn_end,
        rejoin_policy=s.rejoin_policy,
        corruption_rate=s.corruption_rate,
        corruption_kind=s.corruption_kind,
        quarantine_limit=s.quarantine_limit,
    )


def to_sim_cfg(s: Scenario, seed: int | None = None) -> SimCfg:
    # In the exact-SGD simulator PS and all-reduce compute the same mean;
    # the architecture distinguishes them only in the cost model. Gossip
    # changes the dynamics (neighbor mixing instead of exact averaging).
    sync = "gossip" if s.arch == "gossip" else s.sync
    return SimCfg(
        n_workers=s.n_workers,
        sync=sync,
        staleness=s.staleness,
        local_steps=s.local_steps,
        compressor=s.make_compressor(),
        error_feedback=s.error_feedback,
        lr=s.lr,
        steps=s.steps,
        seed=s.seed if seed is None else seed,
        churn=s.churn,
        dropout_rate=s.dropout_rate,
        worker_dropout=s.worker_dropout,
        churn_start=s.churn_start,
        churn_end=s.churn_end,
        rejoin_policy=s.rejoin_policy,
        corruption_rate=s.corruption_rate,
        corruption_kind=s.corruption_kind,
        quarantine_limit=s.quarantine_limit,
    )


# ---------------------------------------------------------------------------
# Roofline substrate: the analytic per-cell terms (no trainer run).
# ---------------------------------------------------------------------------


def _hbm_passes(s: Scenario) -> float:
    """Gradient-sized HBM passes per iteration of the compression pipeline
    (the reference's ``qsgd_ef`` kernel analysis): the dense SGD apply is 3
    (read g, read x, write x); an unfused compress with error feedback adds
    8, a compress without it 2.5, and a compressor with a fused EF kernel
    (the port's ``roundtrip_ef_p``, the reference's
    ``compress_decompress_ef``) adds 4.25."""
    passes = 3.0
    if s.compressor is None:
        return passes
    if s.error_feedback:
        return passes + (4.25 if hasattr(s.make_compressor(), "roundtrip_ef_p") else 8.0)
    return passes + 2.5


def roofline_row(s: Scenario) -> dict[str, Any]:
    """The cell's roofline terms through :mod:`repro_torch.launch.roofline`,
    from its analytic byte and FLOP model (no trainer run): the declared
    ``compute_time`` is turned into FLOPs at the card's peak, so the term
    algebra applies unchanged."""
    from repro_torch.launch import roofline as RL

    eff = estimated_wire_bytes(s)
    rl = RL.Roofline(
        arch=s.arch,
        shape=s.tag(),
        mesh=f"n{s.n_workers}",
        flops=s.compute_time * RL.PEAK_FLOPS,
        hbm_bytes=_hbm_passes(s) * s.msg_bytes,
        coll_bytes=_round_wire_bytes(s, eff) * rounds_per_iter(s),
        coll_bytes_hlo=0.0,
        coll_by_kind={},
    )
    return {
        "t_compute": rl.t_compute,
        "t_memory": rl.t_memory,
        "t_collective": rl.t_collective,
        "iter_time_bound": max(rl.t_compute, rl.t_memory, rl.t_collective),
        "bottleneck": rl.bottleneck,
    }


# ---------------------------------------------------------------------------
# Engine-vs-reference speedup measurement.
# ---------------------------------------------------------------------------

#: the fixed perf-tracking cell: 8 workers, 300 steps, 3 replicas, qsgd+EF.
REFERENCE_SPEEDUP_CELL = Scenario(
    sync="bsp", n_workers=8, steps=300, lr=0.05,
    compressor="qsgd", compressor_kwargs={"levels": 16}, error_feedback=True,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_engine_speedup(s: Scenario = REFERENCE_SPEEDUP_CELL, *, replicas: int = 3,
                           device: str | torch.device = "cuda") -> dict[str, Any]:
    """Wall clock of the batched engine against the per-step loop reference
    on one cell, both on ``device`` and drawing the same noise.
    ``speedup_warm`` reuses the built class program; ``speedup_cold``
    builds it first.  ``max_rel_dev_loss`` and ``max_rel_dev_consensus``
    are the largest ``|engine - loop| / (atol / rtol + |loop|)`` over the
    series (at most 1 within rtol 2e-4 / atol 1e-5), ``max_rel_dev_bits``
    the bits' largest relative deviation."""
    device = torch.device(device)
    problem = PROBLEMS[s.objective](n_workers=s.n_workers, noise=s.grad_noise, seed=s.seed)
    seeds = [s.seed + r for r in range(replicas)]
    cfg = to_sim_cfg(s)

    engine_cache_clear()
    times = []
    for _ in range(2):  # cold (builds the class program), then warm
        t0 = time.perf_counter()
        eng = simulate_training_batch(cfg, problem, seeds=seeds, device=device)
        _sync(device)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = [simulate_training_reference(to_sim_cfg(s, seed=sd), problem, device=device)
           for sd in seeds]
    _sync(device)
    ref_s = time.perf_counter() - t0
    dev = {k: max(float(np.max(np.abs(e[k] - r[k]) / (1e-5 + 2e-4 * np.abs(r[k]))))
                  for e, r in zip(eng, ref)) for k in ("loss", "consensus")}
    dev_bits = max(float(np.max(np.abs(e["bits"] - r["bits"]) / np.maximum(np.abs(r["bits"]), 1.0)))
                   for e, r in zip(eng, ref))
    return {
        "cell": s.tag(),
        "replicas": replicas,
        "steps": s.steps,
        "device": str(device),
        "engine_s_cold": times[0],
        "engine_s_warm": times[1],
        "reference_s": ref_s,
        "speedup_cold": ref_s / times[0],
        "speedup_warm": ref_s / times[1],
        "max_rel_dev_loss": dev["loss"],
        "max_rel_dev_consensus": dev["consensus"],
        "max_rel_dev_bits": dev_bits,
    }


# ---------------------------------------------------------------------------
# The batch runner.
# ---------------------------------------------------------------------------


def _agg(vals: list[float]) -> float:
    return float(np.mean(vals))


def training_shape_key(s: Scenario) -> tuple:
    """Hashable shape-class identity of a training-substrate cell: the engine
    statics (:func:`repro_torch.core.simulate.shape_class_key`: sync scheme,
    workers, steps, EF flag, compressor structure) plus the objective family.
    The problem's arrays are passed per cell, so cells differing only in
    problem seed share the class; lr, staleness, Local-H, compressor knobs
    and gradient noise are values and equally absent."""
    return shape_class_key(to_sim_cfg(s)) + (s.objective,)


_PROBLEM_CACHE: dict[tuple, Any] = {}


def _training_problem(s: Scenario):
    """One problem instance per (objective, n_workers, seed), shared by the
    cells of a shape class.  The factory noise is irrelevant here: the
    runner always passes each cell's ``grad_noise``."""
    key = (s.objective, s.n_workers, s.seed)
    if key not in _PROBLEM_CACHE:
        if len(_PROBLEM_CACHE) > 32:
            _PROBLEM_CACHE.pop(next(iter(_PROBLEM_CACHE)))
        _PROBLEM_CACHE[key] = PROBLEMS[s.objective](
            n_workers=s.n_workers, noise=s.grad_noise, seed=s.seed)
    return _PROBLEM_CACHE[key]


def _run_training_scenarios(
    scenarios: list[Scenario], *, replicas: int = 1, cache: bool = True,
    device: str | torch.device = "cuda", draws: Callable | None = None,
) -> list[ScenarioResult]:
    """Group the cells into shape classes and run each class as one batch;
    results come back in input order.  ``cache=False`` builds a fresh class
    program per call (the per-cell baseline of the sweep measurement);
    ``draws`` is the engine's noise factory (default: one generator per
    cell and replica seed)."""
    for s in scenarios:
        bad = s.violations("training")
        if bad:
            raise ValueError(f"invalid scenario {s.tag()} on training: {'; '.join(bad)}")
    groups: dict[tuple, list[int]] = {}
    for i, s in enumerate(scenarios):
        groups.setdefault(training_shape_key(s), []).append(i)
    results: list[ScenarioResult | None] = [None] * len(scenarios)
    for idxs in groups.values():
        cells = [scenarios[i] for i in idxs]
        outs = simulate_training_classbatch(
            [to_sim_cfg(s) for s in cells],
            problems=[_training_problem(s) for s in cells],
            seeds=[[s.seed + r for r in range(replicas)] for s in cells],
            grad_noise=[s.grad_noise for s in cells],
            cache=cache, device=device, draws=draws,
        )
        for i, s, cell in zip(idxs, cells, outs):
            measured = {
                "final_loss": _agg([float(o["loss"][-1]) for o in cell]),
                "x_star_err": _agg([o["x_star_err"] for o in cell]),
                "consensus": _agg([float(o["consensus"][-1]) for o in cell]),
                "gbits": _agg([float(o["bits"][-1]) for o in cell]) / 1e9,
            }
            if replicas > 1:
                measured["final_loss_std"] = float(
                    np.std([float(o["loss"][-1]) for o in cell]))
            if "quarantine_rounds" in cell[0]:
                # an integrity cell's tallies: worker-rounds quarantined, wire
                # bits sent but not delivered, escalations
                measured["quarantine_rounds"] = _agg(
                    [float(o["quarantine_rounds"][-1]) for o in cell])
                measured["quarantined_gbits"] = _agg(
                    [float(o["quarantined_bits"][-1]) for o in cell]) / 1e9
                measured["escalations"] = _agg([float(o["escalations"][-1]) for o in cell])
            series = {
                "loss": np.stack([o["loss"] for o in cell]),
                "consensus": np.stack([o["consensus"] for o in cell]),
                "bits": np.stack([o["bits"] for o in cell]),
            }
            results[i] = ScenarioResult(s, "training", measured, predict(s, "training"),
                                        replicas=replicas, series=series)
    return results  # type: ignore[return-value]


def run_scenario(s: Scenario, substrate: str = "timeline", *, replicas: int = 1,
                 device: str | torch.device = "cuda",
                 draws: Callable | None = None) -> ScenarioResult:
    """Execute one scenario; replica seeds are ``seed, seed+1, ...``.
    ``device`` reaches the training engine and the trainer, ``draws`` the
    training engine."""
    bad = s.violations(substrate)
    if bad:
        raise ValueError(f"invalid scenario {s.tag()} on {substrate}: {'; '.join(bad)}")
    seeds = [s.seed + r for r in range(replicas)]
    pred = predict(s, substrate) if substrate != "trainer" else {}

    if substrate == "timeline":
        runs = [simulate_timeline(to_timeline_cfg(s, seed=sd)).row() for sd in seeds]
        measured = {k: _agg([r[k] for r in runs]) for k in runs[0]}
        # iter_time = makespan / iters = n_workers / throughput (global
        # throughput counts every worker's iterations).
        measured["iter_time"] = _agg([s.n_workers / r["throughput"] for r in runs])
        return ScenarioResult(s, substrate, measured, pred, replicas=replicas)

    if substrate == "training":
        return _run_training_scenarios([s], replicas=replicas, device=device, draws=draws)[0]

    if substrate == "schedule":
        r = simulate_schedule(
            layer_profile(s.layer_profile),
            n_workers=s.n_workers,
            link=Link(alpha=s.alpha, beta=s.beta),
            alg=s.allreduce_alg,
            mode=s.schedule,
            bucket_bytes=s.bucket_bytes,
            staleness=s.overlap_staleness,
        )
        measured = {k: float(v) for k, v in r.items()}
        return ScenarioResult(s, substrate, measured, pred, replicas=1)

    if substrate == "roofline":
        return ScenarioResult(s, substrate, roofline_row(s), pred, replicas=1)

    if substrate == "trainer":
        from repro_torch.experiments.trainer_substrate import run_trainer_scenario

        return run_trainer_scenario(s, device=device)

    raise ValueError(f"unknown substrate {substrate!r}")


def run_scenarios(
    scenarios: list[Scenario],
    substrate: str = "timeline",
    *,
    replicas: int = 1,
    device: str | torch.device = "cuda",
    draws: Callable | None = None,
) -> list[ScenarioResult]:
    """Run every scenario, preserving order.  Invalid cells raise: filter
    with :func:`repro_torch.experiments.scenario.expand` first.  On the
    ``training`` substrate the list is grouped into shape classes and each
    class runs as one batch: a sweep builds one program per class.  The
    ``trainer`` substrate goes through
    :func:`repro_torch.experiments.trainer_substrate.run_trainer_sweep`, so
    the cells of a trainer shape class share one bundle build."""
    if substrate == "training":
        return _run_training_scenarios(list(scenarios), replicas=replicas, device=device,
                                       draws=draws)
    if substrate == "trainer":
        from repro_torch.experiments.trainer_substrate import run_trainer_sweep

        scenarios = list(scenarios)
        for s in scenarios:
            bad = s.violations("trainer")
            if bad:
                raise ValueError(f"invalid scenario {s.tag()} on trainer: {'; '.join(bad)}")
        results, skipped = run_trainer_sweep(scenarios, device=device)
        if skipped:
            why = "; ".join(f"{s.tag()}: {r}" for s, r in skipped)
            raise ValueError(f"trainer cells not runnable: {why}")
        return results  # type: ignore[return-value]
    return [run_scenario(s, substrate, replicas=replicas) for s in scenarios]


# ---------------------------------------------------------------------------
# Batched-sweep measurement.
# ---------------------------------------------------------------------------


def sweep_matrix_45(*, steps: int = 60, n_workers: int = 8, seed: int = 0,
                    problem_seeds: tuple[int, ...] = (0,)) -> list[Scenario]:
    """The fixed 45-cell perf-tracking sweep: 5 sync/topology schemes x 3
    quantization levels x 3 learning rates (qsgd+EF everywhere), exactly 5
    shape classes.  ``problem_seeds`` replicates the matrix across problem
    instances (45 x len cells) in the same 5 classes."""
    cells = []
    for sync, arch in (("bsp", "allreduce"), ("local", "allreduce"),
                       ("ssp", "ps"), ("asp", "ps"), ("bsp", "gossip")):
        for levels in (4, 8, 16):
            for lr in (0.02, 0.05, 0.08):
                for ps in problem_seeds:
                    cells.append(Scenario(
                        sync=sync, arch=arch, n_workers=n_workers, steps=steps,
                        lr=lr, staleness=4, local_steps=8, compressor="qsgd",
                        compressor_kwargs={"levels": levels}, error_feedback=True,
                        seed=seed + ps))
    return cells


def measure_sweep_speedup(
    scenarios: list[Scenario] | None = None,
    *,
    replicas: int = 1,
    percell: bool = True,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Wall clock and class programs built of the batched sweep against the
    per-cell path (a fresh program per cell) on the same scenario list, and
    the largest deviation between the two result sets."""
    device = torch.device(device)
    scenarios = sweep_matrix_45() if scenarios is None else list(scenarios)
    classes = {training_shape_key(s) for s in scenarios}
    classes_per_problem = {training_shape_key(s) + (s.seed,) for s in scenarios}

    engine_cache_clear()
    t0 = time.perf_counter()
    batched = _run_training_scenarios(scenarios, replicas=replicas, device=device)
    batched_s = time.perf_counter() - t0
    compiles_batched = engine_cache_stats().compiles

    out: dict[str, Any] = {
        "n_cells": len(scenarios),
        "n_shape_classes": len(classes),
        "n_problem_instances": len({(s.objective, s.n_workers, s.seed) for s in scenarios}),
        "n_classes_without_shared_problems": len(classes_per_problem),
        "replicas": replicas,
        "steps": scenarios[0].steps,
        "n_workers": scenarios[0].n_workers,
        "compiles_batched": compiles_batched,
        "batched_s": batched_s,
        "cells_per_s_batched": len(scenarios) / batched_s,
    }
    if not percell:
        return out

    engine_cache_clear()
    t0 = time.perf_counter()
    percell_res = [_run_training_scenarios([s], replicas=replicas, cache=False,
                                           device=device)[0] for s in scenarios]
    percell_s = time.perf_counter() - t0
    compiles_percell = engine_cache_stats().compiles

    dev_loss = max(
        float(np.max(np.abs(b.series["loss"] - p.series["loss"])
                     / np.maximum(np.abs(p.series["loss"]), 1e-6)))
        for b, p in zip(batched, percell_res)
    )
    dev_bits = max(
        float(np.max(np.abs(b.series["bits"] - p.series["bits"])
                     / np.maximum(np.abs(p.series["bits"]), 1.0)))
        for b, p in zip(batched, percell_res)
    )
    out.update({
        "compiles_percell": compiles_percell,
        "percell_s": percell_s,
        "speedup": percell_s / batched_s,
        "max_rel_dev_loss": dev_loss,
        "max_rel_dev_bits": dev_bits,
    })
    return out
