"""Discrete-event and multi-worker training simulators (counterpart of
``repro.core.simulate``).

1. :func:`simulate_timeline` -- the discrete-event model of n workers with
   a straggler distribution under BSP / SSP(s) / ASP / Local-SGD(H) and a
   PS / all-reduce / gossip communication model (alpha-beta costs, PS
   congestion, churn and corruption event streams): Fig. 4 and Table II.
   It is numpy, as the reference's is, and ported one to one.

2. :func:`simulate_training` -- exact multi-worker SGD on convex problems
   (paper section VIII) under every sync scheme (bsp, local, ssp, asp,
   gossip) and every registered compressor, with error feedback or
   without.  :func:`simulate_training_classbatch` runs every cell of one
   *shape class* (same sync scheme, workers, steps, EF flag and compressor
   structure) times its replica seeds times its workers as one batch: the
   state is explicit device tensors -- X and the EF residual (C, R, n,
   dim), the delay line (slots, C, R, n, dim), the wire bits (C, R) -- and
   the cells' values (lr, local steps, staleness, gossip weight, gradient
   noise, compressor knobs) are (C,) tensors, never Python branches.  Each
   step is a fixed set of batched operations whatever C, R and n are (the
   compressors work on the (C*R*n, dim) row stack: one kernel launch per
   step for the kernel-backed ones), the steps are a host loop with no
   host sync, and the loss, consensus and bits series land in
   preallocated device tensors copied to the host once.  A class's built
   program is cached under the reference's compile key, so
   ``engine_cache_stats().compiles`` counts shape classes.
   :func:`simulate_training_reference` keeps the per-step Python loop as
   the semantic baseline.

Noise.  The engine takes a ``draws`` factory; the default
(:class:`GeneratorDraws`) gives each (cell, replica) seed its own
``torch.Generator`` on the engine's device, so a cell run alone equals the
same cell inside a batch.  Torch's Philox cannot replay jax's threefry, so
the parity tests feed the reference's draws through the same hook.

Churn, rejoin and gradient integrity (the reference's masked program): a
churn cell draws a per-step participation mask per worker (two more
uniforms per step from the ``draws`` hook, the mask's and the corruption's,
each (C, R, n)); the mean renormalizes over the live workers, a masked
worker's EF residual freezes and a rejoiner's is dropped at the end of its
rejoin round; ``pull_avg`` pulls a rejoiner to the live-set average under
local SGD and gossip (charged 32 * dim bits a rejoiner); local SGD averages
over the live workers; gossip mixes by :func:`masked_mixing_matrix`.  A
corruption kind corrupts each worker's dense reconstruction (its wire
image) where its flag is set, validates it per row and quarantines an
invalid row for the round; ``quarantine_limit`` consecutive quarantines
escalate into the rejoin path.  Such cells add the series
``quarantined_bits``, ``quarantine_rounds`` and ``escalations``.  The
churn flag, rejoin policy and corruption kind split shape classes; the
dropout and corruption rates, window and quarantine limit are values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.compression.base import (
    batch_knobs,
    batch_param_values,
    merge_representative,
    needs_noise,
    noise_len,
    roundtrip_bits,
    roundtrip_bits_ef,
    shape_fingerprint,
    structural_envelope,
)
from repro_torch.core import integrity
from repro_torch.core.costmodel import round_wire_bytes
from repro_torch.core.gossip import (
    masked_mixing_matrix,
    ring_mixing_matrix,
    ring_mixing_matrix_traced,
)
from repro_torch.core.types import churn_enabled, effective_corruption_kind

f32 = torch.float32


# ---------------------------------------------------------------------------
# 1. Discrete-event timeline simulator (Fig. 4 / Table II), numpy.
# ---------------------------------------------------------------------------


@dataclass
class TimelineCfg:
    n_workers: int = 16
    iters: int = 200
    compute_mean: float = 1.0  # per-iteration compute time
    straggler_sigma: float = 0.2  # lognormal sigma
    straggler_worker_slowdown: float = 1.0  # multiplicative slowdown of worker 0
    # alpha-beta communication model (paper Table III)
    alpha: float = 1e-3  # per-message latency (s)
    beta: float = 1e-9  # per-byte time (s/B)  ~ 1 GB/s links
    msg_bytes: float = 4 * 25e6  # 25M-param f32 model/gradient
    server_bw_share: bool = True  # PS congestion: uploads share server link
    sync: str = "bsp"  # bsp | ssp | asp | local
    staleness: int = 3  # SSP bound
    local_steps: int = 8  # Local SGD H
    arch: str = "ps"  # ps | allreduce | gossip
    seed: int = 0
    # heterogeneity (churn axis): per-worker speed multipliers (1.0 =
    # nominal; empty = homogeneous) and the straggler draw family
    worker_speeds: tuple = ()
    straggler_dist: str = "lognormal"  # lognormal | uniform | none
    # churn as a timeline EVENT STREAM: per-iteration Bernoulli offline
    # draws inside the [churn_start, churn_end) window produce drop/rejoin
    # transitions; every rejoin charges a resync cost through the
    # alpha-beta model ("pull_avg": a full model pull, alpha + beta*N and
    # N wire bytes; "reset": a membership handshake, alpha only).
    dropout_rate: float = 0.0  # per-iteration P(worker offline)
    worker_dropout: tuple = ()  # per-worker override (length n_workers)
    churn_start: int = 0  # first iteration (inclusive) dropout applies
    churn_end: int = -1  # last iteration (exclusive); -1 = until the end
    rejoin_policy: str = "reset"  # reset | pull_avg
    # gradient-integrity axis: per-round P(a live worker's payload is
    # corrupted).  A corrupted round is QUARANTINED — the bytes moved but are
    # booked undelivered — and `quarantine_limit` consecutive quarantines
    # escalate to a forced rejoin (charging the policy's resync cost).
    corruption_rate: float = 0.0
    corruption_kind: str = "none"  # none | nan | inf | spike | bitflip
    quarantine_limit: int = 3


@dataclass
class TimelineResult:
    finish_times: np.ndarray  # (workers, iters) completion wall-clock
    throughput: float  # global iterations/sec
    idle_frac: float
    mean_staleness: float
    comm_frac: float
    bytes_per_worker: float = 0.0  # wire bytes each worker moved (up+down)
    # churn event accounting: rejoin transitions observed and the resync
    # cost they charged (seconds on the rejoiner's clock, bytes on the wire)
    resync_events: int = 0
    resync_seconds: float = 0.0
    resync_bytes: float = 0.0
    # gradient-integrity accounting: rounds whose payload was quarantined
    # (sent but not delivered), the wire bytes they moved, and bounded-
    # quarantine escalations to the rejoin protocol
    quarantine_events: int = 0
    quarantined_bytes: float = 0.0
    escalation_events: int = 0

    def row(self) -> dict:
        return {
            "throughput": self.throughput,
            "idle_frac": self.idle_frac,
            "mean_staleness": self.mean_staleness,
            "comm_frac": self.comm_frac,
            "bytes_per_worker": self.bytes_per_worker,
            "resync_events": self.resync_events,
            "resync_seconds": self.resync_seconds,
            "resync_bytes": self.resync_bytes,
            "quarantine_events": self.quarantine_events,
            "quarantined_bytes": self.quarantined_bytes,
            "escalation_events": self.escalation_events,
        }


def _comm_time(cfg: TimelineCfg, concurrent: int) -> float:
    """Per-iteration communication time under the architecture model."""
    a, b, N = cfg.alpha, cfg.beta, cfg.msg_bytes
    n = cfg.n_workers
    if cfg.arch == "ps":
        # upload + download; server link shared by `concurrent` workers
        share = max(1, concurrent) if cfg.server_bw_share else 1
        return 2 * (a + b * N * share)
    if cfg.arch == "allreduce":
        # ring: 2(n-1) alpha + 2 (n-1)/n beta N   (Table III)
        return 2 * (n - 1) * a + 2 * (n - 1) / n * b * N
    if cfg.arch == "gossip":
        return 2 * (a + b * N)  # exchange with 2 neighbors (parallel links)
    raise ValueError(cfg.arch)


def _comm_bytes(cfg: TimelineCfg) -> float:
    """Per-worker wire bytes of one round (shared costmodel formula)."""
    return round_wire_bytes(cfg.arch, cfg.n_workers, cfg.msg_bytes)


def simulate_timeline(cfg: TimelineCfg) -> TimelineResult:
    rng = np.random.default_rng(cfg.seed)
    n, T = cfg.n_workers, cfg.iters
    if cfg.straggler_dist == "lognormal":
        compute = rng.lognormal(np.log(cfg.compute_mean), cfg.straggler_sigma, (n, T))
    elif cfg.straggler_dist == "uniform":
        # same sigma knob reinterpreted as the half-width fraction
        lo = cfg.compute_mean * max(1e-6, 1.0 - cfg.straggler_sigma)
        hi = cfg.compute_mean * (1.0 + cfg.straggler_sigma)
        compute = rng.uniform(lo, hi, (n, T))
    elif cfg.straggler_dist == "none":
        compute = np.full((n, T), cfg.compute_mean)
    else:
        raise ValueError(cfg.straggler_dist)
    compute[0] *= cfg.straggler_worker_slowdown
    if cfg.worker_speeds:
        if len(cfg.worker_speeds) != n:
            raise ValueError("worker_speeds length must equal n_workers")
        compute /= np.asarray(cfg.worker_speeds, dtype=float)[:, None]

    # churn event stream: Bernoulli offline draws inside the window become
    # drop/rejoin TRANSITIONS; a masked iteration contributes no compute and
    # moves no bytes, and every rejoin charges the policy's resync cost on
    # the rejoiner's clock.  Drawn after the compute draw so churn-free
    # cells reproduce the exact pre-churn trajectories.
    churn_on = bool(cfg.dropout_rate > 0 or any(cfg.worker_dropout))
    alive = np.ones((n, T), dtype=bool)
    rejoin = np.zeros((n, T), dtype=bool)
    resync_t = resync_b = 0.0
    if churn_on:
        if cfg.rejoin_policy not in ("reset", "pull_avg"):
            raise ValueError(
                f"unknown rejoin_policy {cfg.rejoin_policy!r} "
                "(expected 'reset' or 'pull_avg')")
        rates = (np.asarray(cfg.worker_dropout, dtype=float)
                 if cfg.worker_dropout else np.full(n, cfg.dropout_rate))
        if rates.shape[0] != n:
            raise ValueError("worker_dropout length must equal n_workers")
        start = min(max(int(cfg.churn_start), 0), T)
        end = T if cfg.churn_end < 0 else min(int(cfg.churn_end), T)
        if end > start:
            u = rng.uniform(size=(n, end - start))
            alive[:, start:end] = u >= rates[:, None]
        prev = np.concatenate([np.ones((n, 1), bool), alive[:, :-1]], axis=1)
        rejoin = alive & ~prev
        if cfg.rejoin_policy == "pull_avg":
            # a full model pull over the link
            resync_t = cfg.alpha + cfg.beta * cfg.msg_bytes
            resync_b = cfg.msg_bytes
        else:
            resync_t = cfg.alpha  # membership handshake only
        compute = compute * alive + resync_t * rejoin
    resync_events = int(rejoin.sum())
    resync_seconds_total = resync_t * resync_events
    resync_bytes_total = resync_b * resync_events

    # gradient-integrity event stream: per-round Bernoulli corruption draws
    # over the live set (same window as churn).  A corrupted WIRE round is
    # quarantined — the bytes moved but were not delivered — and
    # `quarantine_limit` consecutive quarantines escalate to a forced rejoin
    # that charges the policy's resync cost on the worker's clock.  Drawn
    # after the churn draws so corruption-free cells keep their trajectories.
    corrupt = np.zeros((n, T), dtype=bool)
    esc = np.zeros((n, T), dtype=bool)
    esc_t = esc_b = 0.0
    if cfg.corruption_rate > 0:
        if cfg.corruption_kind not in ("nan", "inf", "spike", "bitflip"):
            raise ValueError(
                f"corruption_rate > 0 needs a corruption_kind "
                f"(got {cfg.corruption_kind!r})")
        if cfg.rejoin_policy not in ("reset", "pull_avg"):
            raise ValueError(
                f"unknown rejoin_policy {cfg.rejoin_policy!r} "
                "(expected 'reset' or 'pull_avg')")
        start = min(max(int(cfg.churn_start), 0), T)
        end = T if cfg.churn_end < 0 else min(int(cfg.churn_end), T)
        if end > start:
            cu = rng.uniform(size=(n, end - start))
            corrupt[:, start:end] = ((cu < cfg.corruption_rate)
                                     & alive[:, start:end])
        # only wire rounds count (local syncs every H-th iteration)
        if cfg.sync == "local":
            wire_round = np.arange(T) % cfg.local_steps == cfg.local_steps - 1
        else:
            wire_round = np.ones(T, dtype=bool)
        corrupt &= wire_round[None, :]
        q = np.zeros(n, dtype=int)
        for t in range(T):
            if not wire_round[t]:
                continue
            q = np.where(alive[:, t] & corrupt[:, t], q + 1,
                         np.where(alive[:, t], 0, q))
            e = q >= cfg.quarantine_limit
            esc[:, t] = e
            q[e] = 0
        if cfg.rejoin_policy == "pull_avg":
            esc_t = cfg.alpha + cfg.beta * cfg.msg_bytes
            esc_b = cfg.msg_bytes
        else:
            esc_t = cfg.alpha  # membership handshake only
        compute = compute + esc_t * esc
    escalation_events = int(esc.sum())
    quarantine_events = int(corrupt.sum())
    # escalation resyncs are real (delivered) transfers — book them with the
    # rejoin resyncs so the per-sync bytes accounting below picks them up
    resync_seconds_total += esc_t * escalation_events
    resync_bytes_total += esc_b * escalation_events

    finish = np.zeros((n, T))
    t = np.zeros(n)  # current wall-clock per worker
    done = np.zeros(n, dtype=int)  # iterations completed
    comm_total = np.zeros(n)
    stale_samples = []
    bytes_per_worker = 0.0
    round_bytes = _comm_bytes(cfg)

    if cfg.sync == "bsp":
        # Vectorized: after every barrier all workers share one clock, so the
        # iteration time is the per-iteration max compute + comm — a single
        # cumulative sum over iterations instead of the per-step Python loop.
        c = _comm_time(cfg, concurrent=n)
        t_end = np.cumsum(compute.max(axis=0) + c)  # (T,) barrier+comm ends
        finish[:] = t_end[None, :]
        t_prev = np.concatenate([[0.0], t_end[:-1]])
        comm_total = (t_end[None, :] - (t_prev[None, :] + compute)).sum(axis=1)
        # masked workers move no payload that round; resync pulls are extra
        bytes_per_worker = (round_bytes * alive.sum() / n
                            + resync_bytes_total / n)
        stale_samples = [0.0]
    elif cfg.sync == "local":
        # Vectorized per H-step segment: workers run free inside a segment
        # (within-segment cumsum), then barrier on the segment max.
        H = cfg.local_steps
        c = _comm_time(cfg, concurrent=n)
        K, rem = divmod(T, H)
        seg_end = 0.0
        if K:
            seg_cum = compute[:, : K * H].reshape(n, K, H).cumsum(axis=2)
            seg_tot = seg_cum[:, :, -1]  # (n, K) per-worker segment compute
            incr = seg_tot.max(axis=0) + c  # (K,) barrier-to-barrier time
            seg_start = np.concatenate([[0.0], np.cumsum(incr)[:-1]])
            fin = seg_start[None, :, None] + seg_cum  # (n, K, H)
            sync_end = seg_start + incr
            fin[:, :, -1] = sync_end[None, :]
            finish[:, : K * H] = fin.reshape(n, K * H)
            comm_total = (sync_end[None, :] - (seg_start[None, :] + seg_tot)).sum(axis=1)
            # a worker masked at the sync point skips that round's exchange
            part = alive[:, H - 1 : K * H : H]  # (n, K) at-sync participation
            bytes_per_worker = round_bytes * part.sum() / n
            seg_end = sync_end[-1]
        if rem:  # trailing partial segment never reaches a sync point
            finish[:, K * H :] = seg_end + compute[:, K * H :].cumsum(axis=1)
        bytes_per_worker += resync_bytes_total / n
        stale_samples = [0.0]
    else:  # ssp / asp: event-driven per worker
        # each worker proceeds; SSP blocks if ahead of slowest by > s
        c_one = _comm_time(cfg, concurrent=max(1, n // 4))  # partial congestion
        for step in range(T * n):
            i = int(np.argmin(t + (done >= T) * 1e18))
            if done[i] >= T:
                break
            if cfg.sync == "ssp":
                lag = done[i] - done.min()
                if lag > cfg.staleness:
                    # wait until the slowest finishes one more iteration
                    j = int(np.argmin(done))
                    wait = max(0.0, t[j] + compute[j, min(done[j], T - 1)] - t[i])
                    t[i] += wait
            start = t[i]
            al = float(alive[i, done[i]])  # masked iter: no compute, no wire
            t[i] += compute[i, done[i]] + c_one * al
            comm_total[i] += c_one * al
            bytes_per_worker += (round_bytes * al
                                 + resync_b * rejoin[i, done[i]]
                                 + esc_b * esc[i, done[i]]) / n
            finish[i, done[i]] = t[i]
            stale_samples.append(done[i] - done.min())
            done[i] += 1

    makespan = finish.max()
    total_iters = (finish > 0).sum()
    busy = compute[:, : finish.shape[1]].sum()
    return TimelineResult(
        finish_times=finish,
        throughput=total_iters / makespan,
        idle_frac=float(1.0 - busy / (makespan * n)),
        mean_staleness=float(np.mean(stale_samples)),
        comm_frac=float(comm_total.sum() / (makespan * n)),
        bytes_per_worker=float(bytes_per_worker),
        resync_events=resync_events,
        resync_seconds=float(resync_seconds_total),
        resync_bytes=float(resync_bytes_total),
        quarantine_events=quarantine_events,
        quarantined_bytes=float(round_bytes * quarantine_events),
        escalation_events=escalation_events,
    )


# ---------------------------------------------------------------------------
# 2. Multi-worker SGD simulator (convergence studies, section VIII).
# ---------------------------------------------------------------------------


@dataclass
class SimCfg:
    n_workers: int = 8
    sync: str = "bsp"  # bsp | ssp | asp | local | gossip
    staleness: int = 4  # fixed delay for asp; max advance for ssp
    local_steps: int = 8
    compressor: Any = None  # a repro_torch.core.compression instance
    error_feedback: bool = False
    lr: float = 0.05
    steps: int = 300
    seed: int = 0
    gossip_w: float = 1.0 / 3.0
    # churn: a per-step participation mask (``churn`` structural; the rates
    # and the [churn_start, churn_end) window are values)
    churn: bool = False
    dropout_rate: float = 0.0  # shared per-step P(worker offline)
    worker_dropout: tuple = ()  # per-worker override (length n_workers)
    churn_start: int = 0  # first step (inclusive) dropout applies
    churn_end: int = -1  # last step (exclusive); -1 = until the end
    #: "reset" drops a rejoiner's EF residual; "pull_avg" also pulls the
    #: live-set parameter average (local SGD, gossip), a dense download
    rejoin_policy: str = "reset"
    # gradient integrity: per-round P(a live worker's payload is corrupted)
    # (a value), the kind (structural), and the consecutive quarantines a
    # worker tolerates before it escalates into the rejoin path
    corruption_rate: float = 0.0
    corruption_kind: str = "none"  # none | nan | inf | spike | bitflip
    quarantine_limit: int = 3


class Problem(tuple):
    """A ``(grad, loss, x0, x_star)`` 4-tuple whose seed-dependent arrays are
    ``data`` (CPU f32 tensors, x_star included), with the structural
    identity ``data_key`` (objective family and shapes) and the factory's
    gradient-noise scale ``noise``.

    ``grad(X, data, noise, z)`` takes the engine's (C, R, n, dim) parameter
    stack, ``data`` with every array stacked over a leading cell axis (C,
    ...), the (C,) noise scales and standard-normal draws z shaped like X,
    and returns the (C, R, n, dim) gradients, worker i of each row against
    its own shard; ``loss(xbar, data)`` maps (C, R, dim) to (C, R)."""

    data: dict
    data_key: tuple
    noise: float

    def __new__(cls, grad, loss, x0, x_star, *, data, data_key, noise=0.0):
        obj = super().__new__(cls, (grad, loss, x0, x_star))
        obj.data = data
        obj.data_key = data_key
        obj.noise = noise
        return obj


# The problems' products run in f64 and round once to f32.  A batched f32
# product on the card picks its kernel (and so its summation order) by the
# batch's shape, so a row's gradient would change in the last bit with the
# number of rows beside it, and a one-ulp change can flip a dither decision;
# an f64 sum of the exact f32 products rounds to the same f32 whatever the
# order, so a cell's trajectory does not depend on its batch.
f64 = torch.float64


def _bmm_t(d: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``d @ A^T`` per cell: d (C, ..., dim), A (C, dim, dim), in f64."""
    C, dim = d.shape[0], d.shape[-1]
    out = torch.bmm(d.reshape(C, -1, dim).to(f64), A.to(f64).transpose(1, 2))
    return out.reshape(d.shape)


def _quadratic_grad(X, data, noise, z):
    g = _bmm_t(X - data["b"][:, None], data["A"]).to(f32)
    return g + noise[:, None, None, None] * z


def _quadratic_loss(xbar, data):
    d = (xbar[:, :, None, :] - data["b"][:, None]).to(f64)
    q = torch.sum(d * _bmm_t(d, data["A"]), dim=-1)
    return (0.5 * torch.mean(q, dim=-1)).to(f32)


def quadratic_problem(dim: int = 64, n_workers: int = 8, noise: float = 0.1, seed: int = 0):
    """f_i(x) = 1/2 (x - b_i)^T A (x - b_i): strongly convex with worker
    heterogeneity; x* = mean_i b_i.  A and b are drawn by the reference's
    numpy calls, so they equal its arrays bitwise."""
    rng = np.random.default_rng(seed)
    evals = np.linspace(0.5, 5.0, dim)
    Q = np.linalg.qr(rng.normal(size=(dim, dim)))[0]
    A = torch.from_numpy((Q @ np.diag(evals) @ Q.T).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(n_workers, dim)) * 1.0).astype(np.float32))
    x_star = b.sum(0) / n_workers
    return Problem(_quadratic_grad, _quadratic_loss, torch.zeros(dim, dtype=f32), x_star,
                   data={"A": A, "b": b, "x_star": x_star},
                   data_key=("quadratic", dim, n_workers), noise=noise)


_LOGISTIC_LAM = 1e-2


def _logistic_grad(X, data, noise, z):
    feats, labels = data["feats"].to(f64), data["labels"].to(f64)
    X64 = X.to(f64)
    zz = torch.einsum("cnsd,crnd->crns", feats, X64)
    r = (torch.sigmoid(zz) - labels[:, None]) / feats.shape[2]
    g = torch.einsum("cnsd,crns->crnd", feats, r) + _LOGISTIC_LAM * X64
    return g.to(f32) + noise[:, None, None, None] * z


def _logistic_loss(xbar, data):
    feats, labels = data["feats"].to(f64), data["labels"].to(f64)
    x64 = xbar.to(f64)
    zz = torch.einsum("cnsd,crd->crns", feats, x64)
    per = torch.mean(torch.logaddexp(torch.zeros_like(zz), zz) - labels[:, None] * zz, dim=-1)
    reg = 0.5 * _LOGISTIC_LAM * torch.sum(x64 * x64, dim=-1)
    return torch.mean(per + reg[:, :, None], dim=-1).to(f32)


def logistic_problem(dim: int = 32, n_workers: int = 8, n_samples: int = 64,
                     noise: float = 0.05, seed: int = 0):
    """Worker-heterogeneous l2-regularized logistic regression: each worker
    holds its own sample shard, drawn around a shifted ground truth (the
    reference's numpy calls: its features and labels bitwise).  x* has no
    closed form; x_star is the heterogeneity-free truth."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(dim,))
    feats = rng.normal(size=(n_workers, n_samples, dim)).astype(np.float32)
    shift = rng.normal(size=(n_workers, dim)) * 0.3
    logits = np.einsum("nsd,nd->ns", feats, w_true[None] + shift)
    labels = (logits + rng.logistic(size=logits.shape) > 0).astype(np.float32)
    x_star = torch.from_numpy(w_true.astype(np.float32))
    return Problem(_logistic_grad, _logistic_loss, torch.zeros(dim, dtype=f32), x_star,
                   data={"feats": torch.from_numpy(feats), "labels": torch.from_numpy(labels),
                         "x_star": x_star},
                   data_key=("logistic", dim, n_workers, n_samples), noise=noise)


PROBLEMS = {
    "quadratic": quadratic_problem,
    "logistic": logistic_problem,
}


# ---------------------------------------------------------------------------
# 2a. Noise.
# ---------------------------------------------------------------------------

#: steps per block of the default draws: a (cell, replica) generator draws
#: its gradient noise, then its compressor noise, DRAW_BLOCK steps at a time
DRAW_BLOCK = 64


#: offset of the seed of a cell's churn generator from its noise seed's
CHURN_SEED = 0x6368 << 32


class GeneratorDraws:
    """The engine's default noise, as a ``draws`` factory: ``GeneratorDraws(
    seeds, steps, n, dim, noise_len, device[, churn=True])`` is the step hook
    ``hook(t) -> (z (C, R, n, dim) standard normal, u (C, R, n, noise_len)
    uniform, or None when noise_len is 0)`` for the (C, R) list of lists
    ``seeds``; with ``churn`` the hook returns two more (C, R, n) uniforms,
    the mask draw and the corruption draw.  Each seed has its own
    ``torch.Generator`` on ``device``, which draws blocks of DRAW_BLOCK steps
    at a time (a block is the same whatever the batch), so a cell's stream
    does not depend on the cells beside it; the churn draws come from a
    second generator per seed (seeded ``seed + CHURN_SEED``), so a churn
    cell's gradient and compressor noise is its churn-free twin's.  The
    draws run once per block, outside the steps."""

    def __init__(self, seeds, steps: int, n: int, dim: int, noise_len: int, device,
                 churn: bool = False):
        self.device = torch.device(device)

        def gens(offset):
            out = []
            for row in seeds:
                row_gens = []
                for sd in row:
                    g = torch.Generator(device=self.device)
                    g.manual_seed(int(sd) + offset)
                    row_gens.append(g)
                out.append(row_gens)
            return out

        self.gens = gens(0)
        self.churn_gens = gens(CHURN_SEED) if churn else None
        self.shape = (len(seeds), len(seeds[0]), n)
        self.steps, self.dim, self.noise_len = steps, dim, noise_len
        self.block = -1

    def _fill(self, block: int) -> None:
        t0 = block * DRAW_BLOCK
        k = min(DRAW_BLOCK, self.steps - t0)
        C, R, n = self.shape
        self.z = torch.empty((k, C, R, n, self.dim), dtype=f32, device=self.device)
        self.u = (torch.empty((k, C, R, n, self.noise_len), dtype=f32, device=self.device)
                  if self.noise_len else None)
        for c, gens in enumerate(self.gens):
            for r, g in enumerate(gens):
                self.z[:, c, r] = torch.randn((k, n, self.dim), generator=g, dtype=f32,
                                              device=self.device)
                if self.noise_len:
                    self.u[:, c, r] = torch.rand((k, n, self.noise_len), generator=g,
                                                 dtype=f32, device=self.device)
        if self.churn_gens is not None:
            self.cu = torch.empty((k, 2, C, R, n), dtype=f32, device=self.device)
            for c, gens in enumerate(self.churn_gens):
                for r, g in enumerate(gens):
                    self.cu[:, :, c, r] = torch.rand((k, 2, n), generator=g, dtype=f32,
                                                     device=self.device)
        self.block = block

    def __call__(self, t: int):
        if t // DRAW_BLOCK != self.block:
            self._fill(t // DRAW_BLOCK)
        i = t - self.block * DRAW_BLOCK
        zu = (self.z[i], (self.u[i] if self.u is not None else None))
        if self.churn_gens is None:
            return zu
        return zu + (self.cu[i, 0], self.cu[i, 1])


# ---------------------------------------------------------------------------
# 2b. The shape-class batched engine.
# ---------------------------------------------------------------------------
#
# A taxonomy cell splits into
#
#   * EngineSpec   -- the structural half: sync scheme, worker count, steps,
#     EF flag, the compressor's structure (its fingerprint), the delay-line
#     depth, and whether the gradient noise is per cell;
#   * CellParams   -- the values: lr, Local-SGD H, staleness, gossip weight,
#     gradient noise, compressor knobs.
#
# Cells with equal EngineSpec (and one problem family) form one shape class
# and run as one batch through one built class program.


@dataclass(frozen=True)
class EngineSpec:
    """Structural half of a cell."""

    sync: str
    n_workers: int
    steps: int
    error_feedback: bool
    comp_key: tuple  # compressor shape fingerprint (("dense",) for None)
    delay_slots: int = 1  # delay-line depth >= max staleness + 1 in the class
    traced_noise: bool = False  # gradient noise given per cell
    churn: bool = False  # participation mask carried through the steps
    #: "reset" | "pull_avg"; "reset" when churn is off
    rejoin_policy: str = "reset"
    #: corruption kind; "none" unless the rate is positive or an explicit
    #: churn keeps a rate-0 cell in the integrity program
    corruption_kind: str = "none"


@dataclass
class CellParams:
    """Values half of a cell.  ``comp`` holds the compressor's knob values
    (``base.batch_param_values``); ``grad_noise`` is None when the
    problem's own noise applies; ``dropout`` (per worker) and the window
    are set only for a churn cell, ``corruption`` only for an integrity
    cell."""

    lr: float = 0.05
    local_steps: int = 8
    staleness: int = 4
    gossip_w: float = 1.0 / 3.0
    grad_noise: float | None = None
    comp: dict[str, float] = field(default_factory=dict)
    dropout: tuple | None = None
    churn_start: float = 0.0
    churn_end: float = float("inf")
    corruption: float | None = None
    quarantine_limit: float = 3.0


def _check_churn(cfg: SimCfg) -> None:
    """The reference's ``split_cfg`` checks on the churn and integrity
    fields (each message names the field)."""
    if cfg.worker_dropout and len(cfg.worker_dropout) != cfg.n_workers:
        raise ValueError("worker_dropout length must equal n_workers")
    if cfg.rejoin_policy not in ("reset", "pull_avg"):
        raise ValueError(f"unknown rejoin_policy {cfg.rejoin_policy!r} "
                         "(expected 'reset' or 'pull_avg')")
    if cfg.corruption_kind not in ("none",) + integrity.KINDS:
        raise ValueError(f"unknown corruption_kind {cfg.corruption_kind!r} "
                         "(expected none|nan|inf|spike|bitflip)")
    if cfg.corruption_rate > 0 and cfg.corruption_kind == "none":
        raise ValueError("corruption_rate > 0 needs a corruption_kind")
    if not 0.0 <= cfg.corruption_rate < 1.0:
        raise ValueError("corruption_rate must be in [0, 1)")
    if cfg.quarantine_limit < 1:
        raise ValueError("quarantine_limit must be >= 1")


def split_cfg(cfg: SimCfg, *, grad_noise: float | None = None,
              dim: int | None = None) -> tuple[EngineSpec, CellParams]:
    """Decompose one :class:`SimCfg` into its structural and value halves.
    ``dim`` (the problem's dimension) is needed when the compressor has
    knobs: element-count knobs such as top-k's k derive from it."""
    if cfg.sync not in ("bsp", "local", "ssp", "asp", "gossip"):
        raise ValueError(cfg.sync)
    _check_churn(cfg)
    if dim is None and cfg.compressor is not None and batch_knobs(cfg.compressor):
        raise ValueError(
            f"split_cfg needs dim to derive {type(cfg.compressor).__name__} "
            f"knob values ({batch_knobs(cfg.compressor)})")
    # the trainer's structural rules, which read the same fields
    churn, kind = churn_enabled(cfg), effective_corruption_kind(cfg)
    spec = EngineSpec(
        sync=cfg.sync,
        n_workers=cfg.n_workers,
        steps=cfg.steps,
        error_feedback=bool(cfg.error_feedback),
        comp_key=shape_fingerprint(cfg.compressor),
        delay_slots=cfg.staleness + 1 if cfg.sync in ("ssp", "asp") else 1,
        traced_noise=grad_noise is not None,
        churn=churn,
        rejoin_policy=cfg.rejoin_policy if churn else "reset",
        corruption_kind=kind,
    )
    dropout = (tuple(float(p) for p in cfg.worker_dropout) if cfg.worker_dropout
               else (float(cfg.dropout_rate),) * cfg.n_workers)
    params = CellParams(
        lr=cfg.lr,
        local_steps=cfg.local_steps,
        staleness=cfg.staleness,
        gossip_w=cfg.gossip_w,
        grad_noise=grad_noise,
        comp=batch_param_values(cfg.compressor, dim) if dim is not None else {},
        dropout=dropout if churn else None,
        churn_start=float(cfg.churn_start),
        churn_end=float(cfg.churn_end) if cfg.churn_end >= 0 else float("inf"),
        corruption=float(cfg.corruption_rate) if kind != "none" else None,
        quarantine_limit=float(cfg.quarantine_limit),
    )
    return spec, params


def shape_class_key(cfg: SimCfg) -> tuple:
    """Hashable grouping key: cells with equal keys (and one problem family)
    run as one batch.  The delay-line depth and structural knob envelopes
    (PowerSGD's largest rank) are not in the key: they resolve to the class
    maximum after grouping."""
    churn = churn_enabled(cfg)
    return (cfg.sync, cfg.n_workers, cfg.steps, bool(cfg.error_feedback),
            shape_fingerprint(cfg.compressor), churn,
            cfg.rejoin_policy if churn else "reset", effective_corruption_kind(cfg))


class ClassProgram:
    """One shape class's built step program: the structural choices (sync
    scheme, EF, compressor representative, problem family) fixed, the
    per-cell values and problem data arriving at :meth:`run` as tensors.
    Every step is the same fixed set of batched operations for any number
    of cells, replicas and workers."""

    def __init__(self, spec: EngineSpec, comp, problem: Problem, C: int, R: int, device):
        self.spec, self.comp, self.C, self.R = spec, comp, C, R
        self.device = torch.device(device)
        self.grad_fn, self.loss_fn = problem[0], problem[1]
        self.dim = problem[2].numel()
        self.noise_len = noise_len(comp, self.dim) if needs_noise(comp) else 0

    def run(self, cells: list[CellParams], data: dict, noise: torch.Tensor, x0: torch.Tensor,
            hook: Callable) -> dict[str, torch.Tensor]:
        spec, comp, dev = self.spec, self.comp, self.device
        C, R, n, dim = self.C, self.R, spec.n_workers, self.dim
        B = C * R * n
        sync, slots = spec.sync, spec.delay_slots
        churn, kind = spec.churn, spec.corruption_kind
        corrupt = kind != "none"
        pull = churn and spec.rejoin_policy == "pull_avg" and sync in ("local", "gossip")

        def col(name, dtype=f32):  # a (C,) tensor of one value of every cell
            return torch.tensor([getattr(c, name) for c in cells], dtype=dtype, device=dev)

        lr = col("lr").view(C, 1, 1, 1)
        # compressor knobs: one value per cell, repeated for its R x n rows
        prow = {k: torch.tensor([c.comp[k] for c in cells], dtype=f32, device=dev)
                .view(C, 1).expand(C, R * n).reshape(B) for k in cells[0].comp}
        if sync == "gossip":
            # (C, 1, n, n); the mix runs in f64 for the reason the problems' do
            # (a churn cell masks the f32 matrix first, as the reference does)
            Wmix = ring_mixing_matrix_traced(n, col("gossip_w"))[:, None]
            if not churn:
                Wmix = Wmix.to(f64)
        if sync == "local":
            H = col("local_steps", torch.int64)
        if sync == "asp":
            s_cell = col("staleness", torch.int64)
            c_idx = torch.arange(C, device=dev)
        if sync == "ssp":
            # workers alternate being ahead: worker i's gradient is i % (s+1)
            # steps old, read from the delay line with one gather
            d_idx = torch.arange(n, device=dev)[None, :] % (col("staleness", torch.int64)[:, None]
                                                            + 1)
            gidx = (torch.arange(C, device=dev)[:, None, None],
                    torch.arange(R, device=dev)[None, :, None],
                    torch.arange(n, device=dev)[None, None, :])

        X = x0.to(dev).expand(C, R, n, dim).clone()
        ef = torch.zeros((C, R, n, dim), dtype=f32, device=dev)
        if sync in ("ssp", "asp"):
            delay = torch.zeros((slots, C, R, n, dim), dtype=f32, device=dev)
        total = torch.zeros((C, R), dtype=f32, device=dev)
        names = ("loss", "consensus", "bits")
        if corrupt:
            names += ("quarantined_bits", "quarantine_rounds", "escalations")
        out = {k: torch.empty((spec.steps, C, R), dtype=f32, device=dev) for k in names}
        dense_bits = torch.full((C, R, n), 32.0 * dim, dtype=f32, device=dev)
        if churn:
            drop = torch.tensor([c.dropout for c in cells], dtype=f32, device=dev).view(C, 1, n)
            c_start, c_end = col("churn_start"), col("churn_end")
            m_prev = torch.ones((C, R, n), dtype=f32, device=dev)
        if corrupt:
            rate_c = col("corruption").view(C, 1, 1)
            qlim = col("quarantine_limit").view(C, 1, 1)
            qc = torch.zeros((C, R, n), dtype=f32, device=dev)
            qb, qr, qe = (torch.zeros((C, R), dtype=f32, device=dev) for _ in range(3))

        def rows_valid(x):  # (C, R, n, dim) -> (C, R, n) 0/1
            return integrity.dense_valid(x.reshape(B, dim), per_row=True).view(C, R, n)

        def pull_from(X, donors, takers):
            """Takers adopt the donors' mean where a donor exists; returns X
            and the bits of the downloads."""
            n_don = donors.sum(-1)
            xpull = (X * donors[..., None]).sum(2) / torch.clamp_min(n_don, 1.0)[..., None]
            take = (takers > 0) & (n_don > 0)[..., None]
            X = torch.where(take[..., None], xpull[:, :, None], X)
            return X, torch.where(n_don > 0, takers.sum(-1) * (32.0 * dim), 0.0)

        for t in range(spec.steps):
            if churn:
                z, u, u_mask, u_corr = hook(t)
                in_window = ((t >= c_start) & (t < c_end)).view(C, 1, 1)
                m = torch.where(in_window & (u_mask < drop), 0.0, 1.0)
                n_alive = torch.clamp_min(m.sum(-1), 1.0)
                # a rejoiner: alive now, masked last step
                rejoined = m * (1.0 - m_prev)
                if pull:  # donors were live both steps
                    X, pulled = pull_from(X, m * m_prev, rejoined)
                    total = total + pulled
                if corrupt:  # only live in-window workers send a payload
                    cflag = torch.where(in_window & (m > 0) & (u_corr < rate_c), 1.0, 0.0)
                    valid_round = torch.ones_like(m)
                    qbits = torch.zeros_like(total)
            else:
                z, u = hook(t)
            G = self.grad_fn(X, data, noise, z)
            if sync in ("ssp", "asp"):
                # a ring of `slots` steps: slot t % slots holds this step's
                # gradients, slot (t - k) % slots those k steps old (zeros
                # before step k, as the reference's rolled line)
                delay[t % slots] = G
                if sync == "asp":
                    G = delay[torch.remainder(t - s_cell, slots), c_idx]
                else:
                    G = delay[(torch.remainder(t - d_idx, slots)[:, None, :],) + gidx]
            ef_prev = ef
            if comp is None:
                Ghat, wb = G, dense_bits
            else:
                u_rows = u.reshape(B, -1) if u is not None else None
                if spec.error_feedback:
                    Ghat, ef_rows, wb = roundtrip_bits_ef(comp, u_rows, G.reshape(B, dim),
                                                          ef.reshape(B, dim), prow)
                    ef = ef_rows.reshape(C, R, n, dim)
                else:
                    Ghat, wb = roundtrip_bits(comp, u_rows, G.reshape(B, dim), prow)
                Ghat, wb = Ghat.reshape(C, R, n, dim), wb.reshape(C, R, n)
            mc = m[..., None] if churn else None
            if sync == "gossip" and churn:
                # dead rows mix as identity rows, dead columns fold into the
                # live rows' self weights; a rejoiner's residual is dropped
                ef = torch.where(rejoined[..., None] > 0, 0.0,
                                 torch.where(mc > 0, ef, ef_prev))
                Y = X - lr * Ghat * mc
                m_eff = m
                if corrupt:
                    # the wire payload is the worker's updated row: a detected
                    # row leaves the mix (its own update stays), an undetected
                    # one mixes in
                    Yw = integrity.corrupt_dense(kind, Y, cflag[..., None])
                    valid = rows_valid(Yw)
                    m_eff = m * valid
                    Y = torch.where(valid[..., None] > 0, Yw, Y)
                    valid_round = valid
                    qbits = (wb * m * (1.0 - valid)).sum(-1)
                Wm = masked_mixing_matrix(Wmix, m_eff).to(f64)
                X = torch.matmul(Wm, Y.to(f64)).to(f32)
                total = total + (wb * m).sum(-1)
            elif sync == "gossip":
                X = torch.matmul(Wmix, (X - lr * Ghat).to(f64)).to(f32)
                total = total + wb.sum(-1)
            else:
                m_ef = m if churn else None
                if corrupt and sync != "local":
                    # the dense image of the wire payload, corrupted where
                    # flagged; a detected row is selected out (NaN * 0 is NaN)
                    Gw = integrity.corrupt_dense(kind, Ghat, cflag[..., None])
                    valid = rows_valid(Gw)
                    Ghat = torch.where(valid[..., None] > 0, Gw, 0.0)
                    m_ef = m * valid
                    valid_round = valid
                    qbits = (wb * m * (1.0 - valid)).sum(-1)
                if churn:  # masked and quarantined rows freeze; a rejoiner's drops
                    ef = torch.where(rejoined[..., None] > 0, 0.0,
                                     torch.where(m_ef[..., None] > 0, ef, ef_prev))
                if sync == "local":
                    X = X - lr * (Ghat * mc if churn else Ghat)
                    is_sync = (t + 1) % H == 0
                    sync4 = is_sync.view(C, 1, 1, 1)
                    if churn:
                        if corrupt:
                            # the payload at a sync point is the parameters: a
                            # detected row leaves the average for one round
                            Xw = integrity.corrupt_dense(kind, X, cflag[..., None])
                            valid = rows_valid(Xw)
                            xs = ((torch.where(valid[..., None] > 0, Xw, 0.0) * mc).sum(2)
                                  / torch.clamp_min((m * valid).sum(-1), 1.0)[..., None])
                            valid_round = torch.where(is_sync.view(C, 1, 1), valid, 1.0)
                            qbits = torch.where(is_sync.view(C, 1),
                                                (wb * m * (1.0 - valid)).sum(-1), 0.0)
                        else:
                            xs = (X * mc).sum(2) / n_alive[..., None]
                        # live workers adopt the live-set average
                        X = torch.where(sync4 & (mc > 0), xs[:, :, None], X)
                        total = total + torch.where(is_sync.view(C, 1), (wb * m).sum(-1), 0.0)
                    else:
                        X = torch.where(sync4, X.mean(2, keepdim=True).expand_as(X), X)
                        # Local SGD communicates only at its sync steps
                        total = total + torch.where(is_sync.view(C, 1), wb.sum(-1), 0.0)
                elif churn:
                    # the live (and valid) rows' mean updates every row
                    den = torch.clamp_min(m_ef.sum(-1), 1.0) if corrupt else n_alive
                    X = X - lr * ((Ghat * mc).sum(2) / den[..., None])[:, :, None]
                    total = total + (wb * m).sum(-1)
                else:  # bsp / ssp / asp: the exact mean of the effective gradients
                    X = X - lr * Ghat.mean(2, keepdim=True)
                    total = total + wb.sum(-1)
            if corrupt:
                # bounded quarantine: consecutive quarantined rounds escalate
                # into the rejoin path (EF reset, and the pull under
                # pull_avg); m_prev keeps the true liveness
                q_new = torch.where(m > 0, torch.where(valid_round > 0, 0.0, qc + 1.0), qc)
                esc = torch.where(q_new >= qlim, 1.0, 0.0)
                ef = torch.where(esc[..., None] > 0, 0.0, ef)
                if pull:
                    X, pulled = pull_from(X, m * valid_round * (1.0 - esc), esc)
                    total = total + pulled
                qc = torch.where(esc > 0, 0.0, q_new)
                qb = qb + qbits
                qr = qr + (m * (1.0 - valid_round)).sum(-1)
                qe = qe + esc.sum(-1)
                out["quarantined_bits"][t] = qb
                out["quarantine_rounds"][t] = qr
                out["escalations"][t] = qe
            if churn:
                m_prev = m
            xbar = X.mean(2)
            out["loss"][t] = self.loss_fn(xbar, data)
            out["consensus"][t] = torch.linalg.vector_norm(X - xbar[:, :, None], dim=-1).mean(-1)
            out["bits"][t] = total
        out["x_star_err"] = torch.linalg.vector_norm(X.mean(2) - data["x_star"][:, None],
                                                     dim=-1)
        return out


@dataclass
class EngineStats:
    """Build and hit counters of the class-program cache: a sweep builds
    one program per shape class."""

    compiles: int = 0
    hits: int = 0

    @property
    def persistent_cache(self) -> dict:
        """The manifest's hits and misses of fresh builds, at class-key
        granularity (:mod:`repro_torch.core.compilecache`)."""
        from repro_torch.core import compilecache

        return compilecache.record("engine")


_ENGINE_STATS = EngineStats()
_ENGINE_CACHE: dict[tuple, ClassProgram] = {}
_ENGINE_CACHE_CAP = 64


def engine_cache_stats() -> EngineStats:
    return _ENGINE_STATS


def engine_cache_clear() -> None:
    """Drop every cached class program and zero the counters."""
    _ENGINE_CACHE.clear()
    _ENGINE_STATS.compiles = 0
    _ENGINE_STATS.hits = 0


def simulate_training_classbatch(
    cfgs: list[SimCfg],
    problem: Problem | None = None,
    *,
    problems: list[Problem] | None = None,
    seeds: list[list[int]] | None = None,
    grad_noise: list[float] | None = None,
    cache: bool = True,
    device: str | torch.device = "cuda",
    draws: Callable | None = None,
) -> list[list[dict[str, np.ndarray]]]:
    """Run every cell of one shape class, times its replica seeds, as one
    batch on ``device``.

    All ``cfgs`` must share :func:`shape_class_key`.  ``problem`` is one
    :class:`Problem` for every cell, or ``problems`` one per cell (equal
    ``data_key``: cells that differ only in problem seed share the
    program).  ``seeds`` gives every cell the same number of replica seeds
    (default ``[[cfg.seed]]``); ``grad_noise`` optionally sets a per-cell
    gradient-noise scale (needed when per-cell problems were built with
    differing noise).  ``draws`` is the noise factory (default
    :class:`GeneratorDraws`); ``cache=False`` builds a fresh program.

    Returns, per cfg, per seed, ``{"loss", "consensus" (steps,) f32, "bits"
    (steps,) f64, "x_star_err" float}`` (an integrity cell adds the
    cumulative ``quarantined_bits``, ``quarantine_rounds`` and
    ``escalations`` series, f64) -- equal to running each cell alone within
    float tolerance.  A churn cell's ``draws`` factory is called with
    ``churn=True`` and its hook returns the two churn uniforms too."""
    if not cfgs:
        return []
    keys = {shape_class_key(c) for c in cfgs}
    if len(keys) > 1:
        raise ValueError(
            f"cfgs span {len(keys)} shape classes ({sorted(map(str, keys))}); "
            "group with shape_class_key() first")
    if problems is not None:
        if len(problems) != len(cfgs):
            raise ValueError("problems must give one Problem per cfg")
        dkeys = {getattr(p, "data_key", None) for p in problems}
        if None in dkeys or len(dkeys) > 1:
            raise ValueError("per-cell problems must be Problem instances sharing one "
                             f"data_key (got {sorted(map(str, dkeys))})")
        problem = problems[0]
    if problem is None:
        problem = PROBLEMS["quadratic"](n_workers=cfgs[0].n_workers, seed=cfgs[0].seed)
    if not isinstance(problem, Problem):
        raise TypeError("the engine needs a Problem (quadratic_problem, logistic_problem)")
    dim = problem[2].numel()
    seeds = [[c.seed] for c in cfgs] if seeds is None else [list(s) for s in seeds]
    if len(seeds) != len(cfgs) or len({len(s) for s in seeds}) != 1:
        raise ValueError("seeds must give every cfg the same replica count")
    noises = [None] * len(cfgs) if grad_noise is None else list(grad_noise)
    if any(nz is None for nz in noises) and any(nz is not None for nz in noises):
        raise ValueError("grad_noise must be set for every cell or for none")

    split = [split_cfg(c, grad_noise=nz, dim=dim) for c, nz in zip(cfgs, noises)]
    spec = split[0][0]
    # structural envelopes of the class: delay depth and knob maxima
    spec = EngineSpec(**{**spec.__dict__, "delay_slots": max(s.delay_slots for s, _ in split)})
    comp = merge_representative([c.compressor for c in cfgs])
    if problems is not None and not spec.traced_noise \
            and len({getattr(p, "noise", 0.0) for p in problems}) > 1:
        raise ValueError("per-cell problems with differing factory noise need grad_noise set")
    device = torch.device(device)
    pkey = (problem.data_key, None if spec.traced_noise else problem.noise)
    C, R = len(cfgs), len(seeds[0])
    cache_key = (spec, structural_envelope(comp), pkey, C, R, str(device))
    if cache and cache_key in _ENGINE_CACHE:
        prog = _ENGINE_CACHE[cache_key]
        _ENGINE_STATS.hits += 1
    else:
        prog = ClassProgram(spec, comp, problem, C, R, device)
        _ENGINE_STATS.compiles += 1
        from repro_torch.core import compilecache

        compilecache.record_compile("engine", cache_key)
        if cache:
            if len(_ENGINE_CACHE) >= _ENGINE_CACHE_CAP:
                _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
            _ENGINE_CACHE[cache_key] = prog

    cells = [p for _, p in split]
    cell_probs = problems if problems is not None else [problem] * C
    data = {k: torch.stack([p.data[k] for p in cell_probs]).to(device) for k in problem.data}
    noise = torch.tensor([nz if spec.traced_noise else problem.noise for nz in noises],
                         dtype=f32, device=device)
    hook = (draws or GeneratorDraws)(seeds, spec.steps, spec.n_workers, dim, prog.noise_len,
                                      device, **({"churn": True} if spec.churn else {}))
    res = prog.run(cells, data, noise, problem[2], hook)
    host = {k: v.cpu().numpy() for k, v in res.items()}  # the one copy to the host
    extras = [k for k in ("quarantined_bits", "quarantine_rounds", "escalations") if k in host]
    return [
        [
            {
                "loss": host["loss"][:, c, r].copy(),
                "consensus": host["consensus"][:, c, r].copy(),
                "bits": host["bits"][:, c, r].astype(np.float64),
                "x_star_err": float(host["x_star_err"][c, r]),
                **{k: host[k][:, c, r].astype(np.float64) for k in extras},
            }
            for r in range(R)
        ]
        for c in range(C)
    ]


def simulate_training_batch(cfg: SimCfg, problem: Problem | None = None, *,
                            seeds: list[int] | None = None,
                            device: str | torch.device = "cuda",
                            draws: Callable | None = None) -> list[dict[str, np.ndarray]]:
    """Every replica seed of one cell as one batch: a one-cell
    :func:`simulate_training_classbatch` (so repeated runs of one cell
    shape reuse the class program)."""
    problem = problem or PROBLEMS["quadratic"](n_workers=cfg.n_workers, seed=cfg.seed)
    seeds = [cfg.seed] if seeds is None else list(seeds)
    return simulate_training_classbatch([cfg], problem, seeds=[seeds], device=device,
                                        draws=draws)[0]


def simulate_training(cfg: SimCfg, problem: Problem | None = None, *,
                      device: str | torch.device = "cuda",
                      draws: Callable | None = None) -> dict[str, np.ndarray]:
    """Exact simulation of n workers under the chosen sync scheme, topology
    and compressor: ``{"loss", "consensus", "bits" (steps,), "x_star_err"}``
    -- the loss of the mean model, the workers' disagreement, the
    cumulative upload bits."""
    return simulate_training_batch(cfg, problem, device=device, draws=draws)[0]


# ---------------------------------------------------------------------------
# 2c. Reference implementation (Python loop, kept for equivalence tests).
# ---------------------------------------------------------------------------


def simulate_training_reference(cfg: SimCfg, problem: Problem | None = None, *,
                                device: str | torch.device = "cuda",
                                draws: Callable | None = None) -> dict[str, np.ndarray]:
    """The per-step Python loop: each worker's compressor called on its own
    flat vector (``compress``/``decompress``), a host sync per step.  The
    semantic baseline the batched engine is tested against, and the
    baseline of ``measure_engine_speedup``; it draws the same noise as the
    engine does for the cell's seed.  As the reference's loop, it runs
    churn-free cells only: a churn or integrity cell raises ``ValueError``
    naming the field (the batched engine runs them)."""
    from repro_torch.core.compression.powersgd import PowerSGD

    for name in ("churn", "dropout_rate", "worker_dropout", "corruption_rate"):
        if getattr(cfg, name):
            raise ValueError(f"SimCfg.{name}={getattr(cfg, name)!r}: the loop reference runs "
                             "churn-free cells only (simulate_training runs churn)")
    problem = problem or quadratic_problem(n_workers=cfg.n_workers, seed=cfg.seed)
    grad_fn, loss_fn, x0, x_star = problem
    device = torch.device(device)
    n, dim, comp = cfg.n_workers, x0.numel(), cfg.compressor
    data = {k: v[None].to(device) for k, v in problem.data.items()}
    noise = torch.tensor([problem.noise], dtype=f32, device=device)
    L = noise_len(comp, dim) if needs_noise(comp) else 0
    hook = (draws or GeneratorDraws)([[cfg.seed]], cfg.steps, n, dim, L, device)
    extra = {"q0": comp.init_q_cols(dim, 7, device)} if isinstance(comp, PowerSGD) else {}

    X = x0.to(device).expand(n, dim).clone()
    ef = torch.zeros((n, dim), dtype=f32, device=device)
    delay_buf = torch.zeros((cfg.staleness + 1, n, dim), dtype=f32, device=device)
    W = None
    if cfg.sync == "gossip":
        W = torch.tensor(ring_mixing_matrix(n, cfg.gossip_w), dtype=f32, device=device)

    losses, consensus, bits = [], [], []
    total_bits = 0.0

    # wire accounting: one upload per worker per communication round, 32
    # bits per element dense, wire_bits compressed, or the measured 64 bits
    # per transmitted coordinate where the analytic size is NaN; local SGD
    # communicates only at its sync steps
    def compress_all(u, G, ef):
        if comp is None:
            return G, ef, 32.0 * dim * n
        a = G + ef if cfg.error_feedback else G
        out = torch.stack([comp.decompress(comp.compress(u[i] if u is not None else None,
                                                         a[i], **extra))
                           for i in range(n)])
        new_ef = (a - out) if cfg.error_feedback else ef
        wb = comp.wire_bits(dim)
        if wb != wb:
            round_bits = 64.0 * sum(int(torch.count_nonzero(out[i])) for i in range(n))
        else:
            round_bits = wb * n
        return out, new_ef, round_bits

    for t in range(cfg.steps):
        z, u = hook(t)
        G = grad_fn(X[None, None], data, noise, z)[0, 0]
        u = u.reshape(n, -1) if u is not None else None
        if cfg.sync in ("bsp", "local", "ssp", "asp"):
            if cfg.sync == "asp":
                delay_buf = torch.roll(delay_buf, 1, 0)
                delay_buf[0] = G
                G_eff = delay_buf[-1]  # `staleness` steps old
            elif cfg.sync == "ssp":
                delay_buf = torch.roll(delay_buf, 1, 0)
                delay_buf[0] = G
                d = np.arange(n) % (cfg.staleness + 1)
                G_eff = torch.stack([delay_buf[d[i], i] for i in range(n)])
            else:
                G_eff = G
            Ghat, ef, wb = compress_all(u, G_eff, ef)
            if cfg.sync == "local":
                X = X - cfg.lr * Ghat
                if (t + 1) % cfg.local_steps == 0:
                    X = X.mean(0, keepdim=True).expand(n, dim).clone()
                    total_bits += wb
            else:
                total_bits += wb
                X = X - cfg.lr * Ghat.mean(0, keepdim=True)
        elif cfg.sync == "gossip":
            Ghat, ef, wb = compress_all(u, G, ef)
            total_bits += wb
            X = W @ (X - cfg.lr * Ghat)
        else:
            raise ValueError(cfg.sync)
        xbar = X.mean(0)
        losses.append(float(loss_fn(xbar[None, None], data)[0, 0]))
        consensus.append(float(torch.linalg.vector_norm(X - xbar[None], dim=1).mean()))
        bits.append(total_bits)

    return {
        "loss": np.asarray(losses),
        "consensus": np.asarray(consensus),
        "bits": np.asarray(bits),
        "x_star_err": float(torch.linalg.vector_norm(X.mean(0) - x_star.to(device))),
    }
