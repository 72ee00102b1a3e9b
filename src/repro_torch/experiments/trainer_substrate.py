"""Run a Scenario through the port's real trainer (the counterpart of
``repro.experiments.trainer_substrate``): the tiny workload of
:func:`make_tiny_workload`, W data-parallel workers stacked on one device
(:mod:`repro_torch.train.steps`), the cell's CommConfig, the sync scheme's
steps by ``Trainer.fit``.

The reference runs each cell on a mesh of W host devices and picks W from
the devices it has.  Here one device holds every worker, so the selection
rule reads the reference's own cap on the devices its CLI lane forces,
:data:`MAX_STACKED`, as the devices available: the same cells run and skip
as there.  ``model_par`` M is the reference's model axis: M shards stacked
beside the workers (:func:`repro_torch.train.steps.build_bundle`'s
``model``), the parameters padded for M.

The predictions use the active calibration profile
(:func:`repro_torch.core.calibrate.get_active`: the fitted link, launch
cost and dense step) when one is installed, else the Scenario's data-sheet
constants; ``predict_*`` also take a ``profile`` explicitly.

The parity hooks of :func:`run_trainer_scenario` and
:func:`run_trainer_sweep` (``params``, ``noise``, ``churn_draws``) reach
``build_bundle`` and the initial state, so a test can hand over the
reference's weights and replay its key chain; by default the weights are
the port's own init from the cell's seed and the draws come from seeded
generators on the device.
"""

from __future__ import annotations

import sys
import time
from typing import Any

import numpy as np
import torch

from repro_torch.experiments.runner import ScenarioResult, _sync
from repro_torch.experiments.scenario import Scenario

#: the reference's cap on the host devices its ``--substrate trainer`` lane
#: forces, ``min(max n_workers, 8)``; one card stacks every worker, so the
#: device-count rule reads this cap as the devices available
MAX_STACKED = 8

def to_comm_config(s: Scenario):
    """Scenario -> the trainer's CommConfig (:mod:`repro_torch.core.types`)."""
    from repro_torch.core.types import CommConfig

    bad = s.violations("trainer")
    if bad:
        raise ValueError(f"scenario {s.tag()} cannot run on the trainer: {'; '.join(bad)}")
    return CommConfig(
        compressor=s.compressor or "none",
        compressor_kwargs=s.kwargs_dict,
        error_feedback=s.error_feedback,
        sync=s.sync,
        # pod_local keeps H under sync="bsp" too: the pod axis is averaged
        # every local_steps, not every step
        local_steps=(s.local_steps if s.sync in ("local", "post_local") or s.pod_local else 1),
        post_local_switch=s.post_local_switch,
        pod_local=s.pod_local,
        aggregator="gossip" if s.arch == "gossip" else "allreduce",
        gossip_compress=s.gossip_compress,
        bucket_mb=s.bucket_bytes / 1e6,
        overlap=s.overlap,
        overlap_staleness=s.overlap_staleness,
        stale_scale=s.stale_scale,
        wire_format=s.wire_format,
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


def stacked_devices(scenarios: list[Scenario]) -> int:
    """The device count the selection rule reads for a sweep on one card:
    the reference's cap, ``min(max n_workers, MAX_STACKED)``."""
    return min(max((s.n_workers for s in scenarios), default=1), MAX_STACKED)


def select_trainer_device_count(s: Scenario, n_devices: int, *, global_batch: int = 64
                                ) -> tuple[int | None, str]:
    """The largest data-parallel worker count that (a) fits ``n_devices``,
    (b) does not exceed the scenario's workers and (c) divides the tiny
    workload's global batch into whole microbatches.  Returns ``(data_par,
    "")`` or ``(None, reason)`` when the cell must be skipped."""
    bad = s.violations("trainer")
    if bad:
        return None, "; ".join(bad)
    mb = max(1, s.microbatch)
    for dp in range(min(s.n_workers, n_devices), 1, -1):
        if s.worker_dropout and dp != s.n_workers:
            # the per-worker rate vector is indexed by worker: the run must
            # realize exactly the scenario's worker count
            continue
        if global_batch % dp == 0 and (global_batch // dp) % mb == 0:
            return dp, ""
    return None, (f"needs a >=2-device mesh dividing batch {global_batch} "
                  f"into {mb} microbatches (have {n_devices} device(s)"
                  + (f"; worker_dropout pins data_par={s.n_workers}"
                     if s.worker_dropout else "") + ")")


def _phase_sync_steps(s: Scenario, steps: int) -> int:
    """Sync steps the trainer fires in [post_local_switch, steps): the sync
    rule tests the absolute step phase ((t+1) % H == 0), so a switch point
    that is not a multiple of H still syncs on the global grid."""
    H = s.local_steps
    return sum(1 for t in range(s.post_local_switch, steps) if (t + 1) % H == 0)


def sync_rounds(s: Scenario, steps: int) -> int:
    """Parameter or gradient synchronization rounds a Scenario performs."""
    if s.sync == "local":
        return steps // s.local_steps
    if s.sync == "post_local":
        return s.post_local_switch + _phase_sync_steps(s, steps)
    return steps


def make_tiny_workload(vocab: int = 128, batch: int = 64, seq: int = 16):
    """The comparison examples' micro-model and bigram data: qwen3-0.6b
    reduced to d_model 128, batch 64 x seq 16 (the reference's sizes)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import BigramSource

    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=vocab, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    shape = InputShape("train", batch, seq, "train")
    src = BigramSource(cfg.vocab, seed=0)

    class Data:
        def batch(self, step):
            return src.batch(step, shape.global_batch, shape.seq_len)

    return cfg, shape, Data()


def trainer_shape_key(s: Scenario, *, data_par: int | None = None, model_par: int = 1) -> tuple:
    """The trainer shape class of a Scenario: the structural
    :func:`repro_torch.core.types.bundle_spec` of its CommConfig, the worker
    count, the model axis and the microbatch count.  Cells with equal keys
    share one bundle build through the registry of
    :mod:`repro_torch.train.steps`; lr, Local-H, the post-local switch,
    compressor value knobs, gossip weights and the stale-gradient scale are
    each cell's own and absent."""
    from repro_torch.core.types import bundle_spec

    return (bundle_spec(to_comm_config(s)), data_par or s.n_workers, model_par,
            max(1, s.microbatch))


def _window_and_rate(s: Scenario) -> tuple[int, float]:
    """The churn window's length in steps and the workers' mean dropout."""
    start = min(max(s.churn_start, 0), s.steps)
    end = s.steps if s.churn_end == -1 else min(s.churn_end, s.steps)
    rates = list(s.worker_dropout) if s.worker_dropout else [s.dropout_rate] * max(1, s.n_workers)
    return max(0, end - start), sum(rates) / len(rates)


def expected_live_fraction(s: Scenario) -> float:
    """Expected fraction of worker-rounds that put a payload on the wire
    under the cell's churn window (a masked worker's round moves no
    payload); 1.0 for churn-free cells; per-worker rates average."""
    if not s.churn or s.steps <= 0:
        return 1.0
    w, p_mean = _window_and_rate(s)
    return 1.0 - p_mean * w / s.steps


def expected_quarantine_fraction(s: Scenario) -> float:
    """Expected fraction of worker-wire-rounds quarantined: alive (1 -
    p_drop), in the window, corrupted (``corruption_rate``) and detected.
    Detection counts as 1 on every format, so on the 1-bit sign wire, which
    carries no redundancy, this is an upper bound."""
    rate = s.corruption_rate
    if not s._corruption_active or rate <= 0 or s.steps <= 0:
        return 0.0
    w, p_mean = _window_and_rate(s)
    return rate * (1.0 - p_mean) * w / s.steps


def trainer_wire_resync_per_step(s: Scenario, wire: dict[str, dict[str, float]]) -> float:
    """Per-step bytes of the dense ``churn_resync`` channel (CHOCO's rejoin
    broadcast), kept out of the payload figure and reported per step of the
    program that carries it."""
    if s.arch == "gossip":
        return wire.get("gossip", {}).get("churn_resync", 0.0)
    rs = wire.get("sync", {}).get("churn_resync", 0.0)
    return rs / s.local_steps if s.sync in ("local", "post_local") else rs


def trainer_wire_per_step(s: Scenario, wire: dict[str, dict[str, float]]) -> float:
    """Per-step wire bytes of one cell from the bundle's booked wire.
    ``post_local`` blends its two phases: per-step gradient aggregation for
    ``post_local_switch`` steps, then one aggregation and one parameter
    average per H-round."""
    ga = wire.get("train", {}).get("grad_agg", 0.0)
    ls = wire.get("sync", {}).get("local_sgd_sync", 0.0)
    if s.arch == "gossip":
        return wire.get("gossip", {}).get("gossip_mix", 0.0)
    if s.pod_local:  # in-pod aggregation every step, the pod average every H
        return ga + ls / s.local_steps
    if s.sync == "local":
        return ls / s.local_steps
    if s.sync == "post_local":
        rounds = _phase_sync_steps(s, s.steps)
        return (s.post_local_switch * ga + rounds * (ga + ls)) / s.steps
    return ga


def trainer_wire_formats(s: Scenario, wire: dict) -> dict[str, float]:
    """Wire bytes by encoding of one call of the cell's aggregation or
    mixing program (f32, bf16, int8, packed1, packed2)."""
    key = "gossip_formats" if s.arch == "gossip" else "train_formats"
    return dict(wire.get(key, {}))


def plan_payload_bytes(plan) -> float:
    """Analytic per-worker payload bytes of one aggregation round of a
    bucket plan: each bucket compressor's ``wire_bits`` (32 bits per
    element without one, or where the size depends on the data)."""
    total = 0.0
    for b in plan.buckets:
        comp = plan.compressor(b)
        wb = comp.wire_bits(b.size) if comp is not None else b.size * 32.0
        if wb != wb:  # NaN
            wb = b.size * 32.0
        total += wb / 8.0
    return total


def _profile(profile):
    """``profile``, else the active calibration profile (None: the data
    sheet's constants)."""
    from repro_torch.core import calibrate

    return calibrate.get_active() if profile is None else profile


def _link_and_launch(s: Scenario, profile):
    from repro_torch.core.costmodel import Link

    if profile is None:
        return Link(alpha=s.alpha, beta=s.beta), 0.0
    return profile.link(), profile.t_launch


def predict_overlap_saving(s: Scenario, *, compute_s: float, payload_round: float,
                           n_buckets: int, data_par: int, link=None,
                           launch: float | None = None, profile=None) -> dict[str, float]:
    """The section VII prediction of one trainer cell: its own message
    structure (microbatch rounds x buckets, ``payload_round`` bytes a round
    from :func:`plan_payload_bytes`, ``compute_s`` from the measured step)
    through :func:`repro_torch.core.schedule.simulate_schedule`; returns the
    predicted step time, the overlap saving against the sequential schedule
    of the same cell and the communication time.  The link and per-message
    launch cost come from ``profile`` (default: the active one) when there
    is one, else from the Scenario's constants and 0."""
    from repro_torch.core.schedule import LayerSpec, simulate_schedule

    n = max(2, data_par)
    M = max(1, s.microbatch)
    rounds = M if s.overlap == "pipelined" else 1
    nb = max(1, n_buckets)
    default_link, default_launch = _link_and_launch(s, _profile(profile))
    link = default_link if link is None else link
    launch = default_launch if launch is None else launch

    def simulate(n_rounds: int, mode: str) -> dict:
        layers = [LayerSpec(f"r{k}b{j}", grad_bytes=payload_round / nb,
                            backward_time=compute_s / (n_rounds * nb))
                  for k in range(n_rounds) for j in range(nb)]
        return simulate_schedule(layers, n_workers=n, link=link, alg=s.allreduce_alg,
                                 mode=mode, staleness=s.overlap_staleness, launch=launch)

    seq = simulate(1, "sequential")
    pipe = simulate(rounds, "pipelined")
    own = pipe if s.overlap == "pipelined" else seq
    return {"iter_time": own["iter_time"],
            "overlap_saving_s": seq["iter_time"] - pipe["iter_time"],
            "comm_time": own["total_comm_time"]}


def predict_trainer_step(s: Scenario, *, data_par: int, payload_round: float, n_buckets: int,
                         profile=None) -> dict[str, float]:
    """Analytic per-step time of any trainer cell: the compute term plus
    (sync rounds per step) x (the collective's cost for the cell's payload
    plus the launch cost of its messages).  With ``profile`` (default: the
    active one) its link, launch and dense step time apply; without one the
    Scenario's data-sheet constants (``compute_time`` et al.)."""
    from repro_torch.core.costmodel import allreduce_cost, gossip_cost

    profile = _profile(profile)
    link, launch = _link_and_launch(s, profile)
    compute = s.compute_time
    if profile is not None and profile.t_step_dense is not None:
        compute = profile.t_step_dense
    n = max(2, data_par)
    msgs = max(1, n_buckets) * (max(1, s.microbatch) if s.overlap == "pipelined" else 1)
    if s.arch == "gossip":
        wire = gossip_cost(payload_round, link=link)
    else:
        wire = allreduce_cost(s.allreduce_alg, n, payload_round, link)
    comm = sync_rounds(s, s.steps) / max(1, s.steps) * (wire + launch * msgs)
    return {"step_time_s": compute + comm, "comm_time_s": comm,
            "calibrated": float(profile is not None)}


def run_trainer_scenario(s: Scenario, *, data_par: int | None = None, model_par: int = 1,
                         momentum: float = 0.0, log_every: int | None = None,
                         bundle_cache: bool = True, device: str | torch.device = "cuda",
                         params: Any = None, noise=None, churn_draws=None) -> ScenarioResult:
    """Train the tiny workload under the scenario's CommConfig on
    ``device``: final loss, per-step wall clock (the first step excluded),
    wire bytes per step (from the bundle's booked wire, shared by the cells
    of a class), sync rounds, and under churn or corruption the expected
    live share and the quarantine tallies of the comm state.  Every cell
    carries :func:`predict_trainer_step`; pipelined cells also
    :func:`predict_overlap_saving`.  ``bundle_cache=False`` forces a fresh
    build (the per-cell baseline).  ``params`` (the initial parameter tree,
    copied; padded for ``model_par``), ``noise`` and ``churn_draws`` reach
    the bundle."""
    from repro_torch.optim.optimizers import momentum_sgd
    from repro_torch.optim.schedules import constant
    from repro_torch.train.steps import build_bundle
    from repro_torch.train.trainer import Trainer
    from repro_torch.utils.tree import tree_map

    comm = to_comm_config(s)
    cfg, shape, data = make_tiny_workload()
    dp = data_par or s.n_workers
    mb = max(1, s.microbatch)
    if (shape.global_batch // dp) % mb != 0:
        raise ValueError(f"{s.tag()}: local batch {shape.global_batch // dp} does not split "
                         f"into {mb} microbatches")
    device = torch.device(device)
    bundle = build_bundle(cfg, comm, momentum_sgd(momentum), shape, n_workers=dp, seed=s.seed,
                          device=device, noise=noise, microbatch=mb, churn_draws=churn_draws,
                          model=model_par, cache=bundle_cache)
    trainer = Trainer(bundle, data, constant(s.lr), log_every=1)
    if params is None:
        state = trainer.init(s.seed)
    else:  # a private copy: the steps update the parameters in place
        state = bundle.init_state(tree_map(lambda p: p.detach().clone(), params))
    state = trainer.fit(state, s.steps)
    _sync(device)

    # the first logged step pays the kernels' first launches; the rest amortize
    walls = [h["wall"] for h in trainer.history]
    step_s = (walls[-1] - walls[0]) / (len(walls) - 1) if len(walls) > 1 else walls[0]
    wire = bundle.wire or {}
    measured: dict[str, Any] = {
        "final_loss": float(trainer.history[-1]["loss"]),
        "step_time_s": float(step_s),
        "wire_kb_per_step": trainer_wire_per_step(s, wire) / 1e3,
        "sync_rounds": float(sync_rounds(s, s.steps)),
        "wire_format_kb": {fmt: b / 1e3 for fmt, b in trainer_wire_formats(s, wire).items()},
    }
    if s.churn:
        # a masked worker's round books no payload: the live-weighted figure
        # is the expected traffic; the resync channel is reported apart
        frac = expected_live_fraction(s)
        measured["live_fraction"] = float(frac)
        measured["wire_kb_per_step_alive"] = measured["wire_kb_per_step"] * frac
        measured["wire_format_kb"] = {fmt: kb * frac
                                      for fmt, kb in measured["wire_format_kb"].items()}
        measured["wire_resync_kb_per_step"] = trainer_wire_resync_per_step(s, wire) / 1e3
    if s._corruption_active:
        # the tallies of the final comm state, (W,) each (the reference's are
        # per (worker, shard), hence its division by model_par); the
        # wire-rounds denominator is sync rounds x microbatch rounds of a
        # pipelined cell
        cst = state["comm"]
        q_rounds = float(cst["quarantine_total"].to("cpu", torch.float64).sum())
        esc = float(cst["escalation_total"].to("cpu", torch.float64).sum())
        rounds = sync_rounds(s, s.steps) * (mb if s.overlap == "pipelined" else 1)
        measured["quarantine_rounds"] = q_rounds
        measured["escalations"] = esc
        qfrac_meas = q_rounds / max(1.0, float(rounds * dp))
        measured["quarantine_fraction"] = qfrac_meas
        measured["wire_kb_per_step_quarantined"] = measured["wire_kb_per_step"] * qfrac_meas
    payload = plan_payload_bytes(bundle.bucket_plan)
    n_buckets = len(bundle.bucket_plan.buckets)
    predicted: dict[str, Any] = predict_trainer_step(s, data_par=dp, payload_round=payload,
                                                     n_buckets=n_buckets)
    if s._corruption_active:
        qfrac = expected_quarantine_fraction(s)
        predicted["quarantine_fraction"] = qfrac
        predicted["wire_kb_per_step_quarantined"] = measured["wire_kb_per_step"] * qfrac
    if s.overlap == "pipelined":
        predicted.update(predict_overlap_saving(s, compute_s=float(step_s),
                                                payload_round=payload, n_buckets=n_buckets,
                                                data_par=dp))
    every = log_every or max(1, s.steps - 1)
    series = {"loss": np.asarray([h["loss"] for h in trainer.history
                                  if h["step"] % every == 0 or h["step"] == s.steps - 1]),
              "loss_full": np.asarray([h["loss"] for h in trainer.history])}
    return ScenarioResult(s, "trainer", measured, predicted=predicted, replicas=1, series=series)


def run_trainer_sweep(scenarios: list[Scenario], *, n_devices: int | None = None,
                      data_par: int | None = None, model_par: int = 1, momentum: float = 0.0,
                      log_every: int | None = None, bundle_cache: bool = True,
                      verbose: bool = False, device: str | torch.device = "cuda",
                      params: Any = None, noise=None, churn_draws=None,
                      ) -> tuple[list[ScenarioResult | None], list[tuple[Scenario, str]]]:
    """Run a Scenario list on the trainer, grouped by trainer shape class so
    each class builds once up front and cannot be evicted mid-class.  Worker
    counts come from ``data_par`` (fixed) or per cell from
    :func:`select_trainer_device_count` over ``n_devices`` (default:
    :func:`stacked_devices`).  Returns ``(results, skipped)``: results in
    input order (``None`` for a skipped cell) and the skip reasons."""
    if data_par is None and n_devices is None:
        n_devices = stacked_devices(scenarios)

    plan: list[tuple[int, Scenario, int]] = []
    skipped: list[tuple[Scenario, str]] = []
    for i, s in enumerate(scenarios):
        if data_par is not None:
            plan.append((i, s, data_par))
            continue
        dp, why = select_trainer_device_count(s, n_devices)
        if dp is None:
            skipped.append((s, why))
        else:
            plan.append((i, s, dp))

    groups: dict[tuple, list[tuple[int, Scenario, int]]] = {}
    for item in plan:
        groups.setdefault(trainer_shape_key(item[1], data_par=item[2], model_par=model_par),
                          []).append(item)

    results: list[ScenarioResult | None] = [None] * len(scenarios)
    for items in groups.values():
        for i, s, dp in items:
            if verbose:
                print(f"# trainer cell {s.tag()}: data_par={dp}", file=sys.stderr)
            results[i] = run_trainer_scenario(
                s, data_par=dp, model_par=model_par, momentum=momentum, log_every=log_every,
                bundle_cache=bundle_cache, device=device, params=params, noise=noise,
                churn_draws=churn_draws)
    _attach_measured_overlap_saving(results)
    return results, skipped


def _overlap_twin(s: Scenario) -> Scenario:
    """The canonical sequential form of a cell (overlap reset, its inert
    knobs normalized), applied to both sides of the pairing."""
    return s.replace(overlap="sequential", overlap_staleness=1, stale_scale=1.0)


def _attach_measured_overlap_saving(results: list) -> None:
    """A pipelined cell whose sequential twin ran in the same sweep gets
    ``measured["overlap_saving_s"]``: the twin's step time minus its own."""
    seq_step: dict[Scenario, float] = {
        _overlap_twin(r.scenario): r.measured["step_time_s"]
        for r in results if r is not None and r.scenario.overlap == "sequential"}
    for r in results:
        if r is None or r.scenario.overlap != "pipelined":
            continue
        twin = seq_step.get(_overlap_twin(r.scenario))
        if twin is not None:
            r.measured["overlap_saving_s"] = twin - r.measured["step_time_s"]


def trainer_matrix_8(*, steps: int = 24, n_workers: int = 4, seed: int = 0) -> list[Scenario]:
    """2 sync schemes (bsp, local) x 2 compressor families (qsgd,
    terngrad) x 2 knob values = 8 cells in 4 shape classes."""
    return _trainer_matrix(steps=steps, n_workers=n_workers, seed=seed, knobs_per_family=2)


def trainer_matrix_16(*, steps: int = 24, n_workers: int = 4, seed: int = 0) -> list[Scenario]:
    """The BENCH_trainer matrix: 2 sync schemes x 2 compressor families x 4
    knob values = 16 cells, still 4 shape classes (4 builds, not 16)."""
    return _trainer_matrix(steps=steps, n_workers=n_workers, seed=seed, knobs_per_family=4)


def _trainer_matrix(*, steps: int, n_workers: int, seed: int,
                    knobs_per_family: int) -> list[Scenario]:
    families = (
        ("qsgd", ({"levels": 4}, {"levels": 16}, {"levels": 8}, {"levels": 32})),
        ("terngrad", ({"clip_sigma": 0.0}, {"clip_sigma": 2.5},
                      {"clip_sigma": 1.5}, {"clip_sigma": 3.5})),
    )
    return [Scenario(sync=sync, local_steps=4, n_workers=n_workers, steps=steps, lr=0.1,
                     compressor=comp, compressor_kwargs=kw, error_feedback=True, seed=seed)
            for sync in ("bsp", "local") for comp, kwargs in families
            for kw in kwargs[:knobs_per_family]]


def measure_trainer_sweep(scenarios: list[Scenario] | None = None, *,
                          data_par: int | None = None, model_par: int = 1,
                          device: str | torch.device = "cuda") -> dict[str, Any]:
    """Wall clock and bundle builds of the class-shared trainer sweep
    against the per-cell path (a fresh build per cell) on ``device``, and
    the largest relative deviation between their loss series (the record
    behind ``BENCH_trainer.json`` in the reference)."""
    from repro_torch.train.steps import bundle_cache_clear, bundle_cache_stats

    device = torch.device(device)
    scenarios = trainer_matrix_16() if scenarios is None else list(scenarios)
    classes = {trainer_shape_key(s, data_par=data_par, model_par=model_par)
               for s in scenarios if not s.violations("trainer")}

    bundle_cache_clear()
    t0 = time.perf_counter()
    shared, skipped = run_trainer_sweep(scenarios, data_par=data_par, model_par=model_par,
                                        device=device)
    _sync(device)
    shared_s = time.perf_counter() - t0
    st = bundle_cache_stats()
    builds_shared, hits_shared = st.builds, st.hits

    bundle_cache_clear()
    t0 = time.perf_counter()
    percell, _ = run_trainer_sweep(scenarios, data_par=data_par, model_par=model_par,
                                   bundle_cache=False, device=device)
    _sync(device)
    percell_s = time.perf_counter() - t0
    builds_percell = bundle_cache_stats().builds

    ran = [(a, b) for a, b in zip(shared, percell) if a is not None and b is not None]
    dev_loss = max((float(np.max(np.abs(a.series["loss"] - b.series["loss"])
                                 / np.maximum(np.abs(b.series["loss"]), 1e-6)))
                    for a, b in ran), default=float("nan"))
    return {
        "n_cells": len(scenarios),
        "n_skipped": len(skipped),
        "n_shape_classes": len(classes),
        "steps": scenarios[0].steps,
        "device": str(device),
        "builds_shared": builds_shared,
        "cache_hits": hits_shared,
        "builds_percell": builds_percell,
        "shared_s": shared_s,
        "percell_s": percell_s,
        "speedup": percell_s / shared_s,
        "max_rel_dev_loss": dev_loss,
        "wire_kb_per_step": {r.tag: r.measured["wire_kb_per_step"]
                             for r in shared if r is not None},
    }
