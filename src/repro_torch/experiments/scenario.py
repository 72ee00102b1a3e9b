"""One point in the survey's taxonomy matrix, and helpers to enumerate it
(the port's own copy of ``repro.experiments.scenario``).

A :class:`Scenario` pins every knob of the four dimensions (Table I):

* **synchronization** (§III): ``sync`` + SSP bound / ASP delay / Local-SGD H;
* **architecture** (§IV): PS / all-reduce (+ Table III algorithm) / gossip;
* **compression** (§V/§VI): registry compressor + kwargs + error feedback;
* **scheduling** (§VII): sequential / WFBP / MG-WFBP + bucket size;

plus the workload (objective, layer profile, worker count, steps) and the
alpha-beta link parameters shared by all cost models.

``grid()`` crosses axis value-lists into the raw product; ``expand()``
additionally drops combinations that are invalid — either universally
(all-reduce is a synchronous collective, so it cannot serve ASP/SSP) or for
a given substrate (SSP/ASP exist only in the simulators; they cannot run in
one SPMD program).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, fields, replace
from typing import Any, Iterable, Mapping

SYNC_SCHEMES = ("bsp", "ssp", "asp", "local", "post_local")
ARCHITECTURES = ("ps", "allreduce", "gossip")
SCHEDULE_MODES = ("sequential", "wfbp", "mgwfbp", "pipelined")
OVERLAP_MODES = ("sequential", "pipelined")
SUBSTRATES = ("timeline", "training", "schedule", "roofline", "trainer")
#: registry names whose compressors define a compressed-domain wire
#: reduction (a ``wire_reduce`` class attribute).  Kept as a static set so
#: ``expand()`` can filter grids without importing a compressor;
#: ``bundle_spec`` re-checks the authoritative attribute at build time, so a
#: drifted entry here fails loudly rather than silently.
WIRE_REDUCE_FAMILIES = frozenset({
    "signsgd", "signsgd_packed", "terngrad", "terngrad_kernel",
    "qsgd", "qsgd_kernel",
})

#: sync schemes that only exist in the simulators (no single SPMD program
#: can express bounded staleness / full asynchrony).
SIMULATE_ONLY_SYNC = ("ssp", "asp")


def _freeze_kwargs(kw: Mapping[str, Any] | Iterable | None) -> tuple:
    if not kw:
        return ()
    if isinstance(kw, Mapping):
        return tuple(sorted(kw.items()))
    return tuple(sorted(tuple(kw)))


@dataclass(frozen=True)
class Scenario:
    """A single taxonomy cell. Frozen + hashable so scenario lists can be
    deduplicated, cached, and used as dict keys by sweep runners."""

    # --- synchronization (§III) ---------------------------------------------
    sync: str = "bsp"  # bsp | ssp | asp | local | post_local (trainer only)
    staleness: int = 4  # SSP bound / ASP fixed delay
    local_steps: int = 8  # Local-SGD H
    post_local_switch: int = 0  # post-local SGD: step where BSP -> local
    pod_local: bool = False  # BSP inside pods, Local-SGD across (§III-D)

    # --- architecture (§IV) --------------------------------------------------
    arch: str = "allreduce"  # ps | allreduce | gossip
    allreduce_alg: str = "ring"  # Table III algorithm
    ps_congested: bool = True  # server link shared by all uploads
    gossip_peers: int = 2
    gossip_compress: str = "none"  # trainer substrate: choco | dcd | none

    # --- compression (§V/§VI) ------------------------------------------------
    compressor: str | None = None  # repro_torch.core.compression registry name
    compressor_kwargs: tuple = ()  # frozen (key, value) pairs
    error_feedback: bool = False
    #: EXECUTABLE wire-format axis (trainer substrate): "compressed" keeps
    #: the payload packed across the wire (1-bit sign, 2-bit ternary, int8
    #: codes, bf16 dense) and reduces via fused Pallas unpack+accumulate
    #: kernels — STRUCTURAL (swaps psum for gather+kernel programs).  Sign
    #: majority stays bit-identical to the dense path; qsgd/terngrad stay
    #: within reassociation tolerance (see README "Performance").
    wire_format: str = "dense"  # dense | compressed

    # --- scheduling (§VII) ---------------------------------------------------
    schedule: str = "wfbp"  # sequential | wfbp | mgwfbp | pipelined (DAG model)
    bucket_bytes: float = 0.0  # MG-WFBP / runtime bucket size (bytes)
    #: EXECUTABLE overlap axis (trainer substrate): "pipelined" starts each
    #: microbatch's bucket all-reduces inside the gradient-accumulation scan
    #: with no data dependency on the next microbatch's compute; the DAG
    #: model's counterpart is ``schedule="pipelined"``.
    overlap: str = "sequential"  # sequential | pipelined
    overlap_staleness: int = 1  # pipelined: 1 = cross-step double buffer, 0 = flush
    stale_scale: float = 1.0  # weight of the stale contribution (traced knob)
    microbatch: int = 1  # gradient-accumulation microbatches (trainer)

    # --- workload ------------------------------------------------------------
    objective: str = "quadratic"  # training substrate: quadratic | logistic
    layer_profile: str = "resnet50"  # schedule substrate layer shapes
    n_workers: int = 8
    steps: int = 300
    lr: float = 0.05
    grad_noise: float = 0.1  # stochastic-gradient noise scale (training)
    seed: int = 0
    compute_time: float = 1.0  # mean per-iteration compute (timeline)
    straggler_sigma: float = 0.2  # lognormal compute-time spread
    straggler_slowdown: float = 1.0  # multiplicative slowdown of worker 0

    # --- churn / heterogeneity (survey future directions: elastic fleets) ----
    #: Structural flag: a churn cell carries the per-step participation mask
    #: through the program (different scan body / aggregation graph), so it
    #: IS a shape-class boundary. The VALUES below stay traced: cells that
    #: differ only in dropout probabilities share one compile/bundle.
    churn: bool = False
    dropout_rate: float = 0.0  # per-step P(worker offline) while in window
    #: per-worker dropout probabilities (overrides dropout_rate; length must
    #: equal n_workers). 0.0 = always alive, 1.0 = always dead in-window.
    worker_dropout: tuple = ()
    churn_start: int = 0  # first step (inclusive) where dropout applies
    churn_end: int = -1  # last step (exclusive); -1 = until the end
    #: how a worker re-enters after a masked-out round (STRUCTURAL: the two
    #: policies compile different resync graphs; normalized to "reset" when
    #: churn is off so it never splits churn-free classes):
    #: * "reset"    — compressor state (EF residual, momentum, factors,
    #:                mirrors) resets to zeros; parameters re-enter through
    #:                the scheme's own mixing/averaging.
    #: * "pull_avg" — additionally pulls the live-set parameter average
    #:                (excluded as a donor while stale); the transfer is
    #:                charged as a dense resync download.
    rejoin_policy: str = "reset"
    #: per-worker compute-speed multipliers for the timeline substrate
    #: (length n_workers; 1.0 = nominal). Generalizes straggler_slowdown.
    worker_speeds: tuple = ()
    straggler_dist: str = "lognormal"  # lognormal | uniform | none

    # --- gradient integrity (fault injection + quarantine) --------------------
    #: per-round P(a live worker's wire payload is corrupted) — traced, so
    #: corruption-rate siblings share one compile/bundle.  Implies churn.
    corruption_rate: float = 0.0
    #: STRUCTURAL corruption family injected post-compression (in the wire
    #: domain): nan | inf | spike | bitflip | none.
    corruption_kind: str = "none"
    #: consecutive quarantined rounds before escalating to the rejoin
    #: protocol (traced knob).
    quarantine_limit: int = 3

    # --- link / message model ------------------------------------------------
    alpha: float = 1e-3  # per-message latency (s)
    beta: float = 1e-9  # per-byte time (s/B)
    msg_bytes: float = 4 * 25e6  # dense gradient size on the wire

    def __post_init__(self):
        object.__setattr__(self, "compressor_kwargs",
                           _freeze_kwargs(self.compressor_kwargs))
        if self.compressor in ("none", ""):
            object.__setattr__(self, "compressor", None)
        object.__setattr__(self, "worker_dropout", tuple(self.worker_dropout))
        object.__setattr__(self, "worker_speeds", tuple(self.worker_speeds))
        # churn is implied by any nonzero dropout so sweeps can vary
        # dropout_rate alone; all implied cells share the churn=True class.
        # Corruption rides the same participation-mask machinery (a
        # quarantined round IS a one-round drop), so it implies churn too.
        if (self.dropout_rate > 0 or any(self.worker_dropout)
                or self.corruption_rate > 0):
            object.__setattr__(self, "churn", True)

    # -- convenience ----------------------------------------------------------

    @property
    def kwargs_dict(self) -> dict[str, Any]:
        return dict(self.compressor_kwargs)

    def make_compressor(self):
        """Instantiate the registry compressor (None for the dense cell)."""
        if self.compressor is None:
            return None
        from repro_torch.core.compression import get_compressor

        return get_compressor(self.compressor, **self.kwargs_dict)

    def tag(self) -> str:
        """Stable human-readable cell name, e.g. ``local_H8/ring/topk_ef``."""
        sync = self.sync
        if sync == "local":
            sync = f"local_H{self.local_steps}"
        elif sync == "post_local":
            sync = f"postlocal{self.post_local_switch}_H{self.local_steps}"
        elif sync in ("ssp", "asp"):
            sync = f"{sync}_s{self.staleness}"
        arch = self.arch if self.arch != "allreduce" else self.allreduce_alg
        comp = self.compressor or "none"
        if self.compressor_kwargs:
            comp += "[" + ",".join(f"{k}={v}" for k, v in self.compressor_kwargs) + "]"
        if self.error_feedback:
            comp += "_ef"
        if self.wire_format != "dense":
            comp += "+cwire"
        sched = self.schedule
        if sched == "mgwfbp":
            sched += f"_{self.bucket_bytes / 1e6:g}MB"
        if self.overlap == "pipelined":
            sched += f"+pipe_s{self.overlap_staleness}"
            if self.microbatch > 1:
                sched += f"_mb{self.microbatch}"
        cell = f"{sync}/{arch}/{comp}/{sched}"
        if self.churn:
            if self.worker_dropout:
                cell += f"+drop[{','.join(f'{p:g}' for p in self.worker_dropout)}]"
            else:
                cell += f"+drop{self.dropout_rate * 100:g}%"
            if self.rejoin_policy != "reset":
                cell += f"+rejoin={self.rejoin_policy}"
            if self._corruption_active:
                cell += (f"+corrupt{self.corruption_rate * 100:g}%"
                         f"{self.corruption_kind}")
        return cell

    @property
    def _corruption_active(self) -> bool:
        """The integrity program is in the cell's class (the reference's
        ``effective_corruption_kind``)."""
        return (self.corruption_rate > 0
                or (self.churn and self.corruption_kind != "none"))

    def replace(self, **kw) -> "Scenario":
        return replace(self, **kw)

    # -- validity -------------------------------------------------------------

    def violations(self, substrate: str | None = None) -> list[str]:
        """Why this taxonomy cell is meaningless (empty list = valid)."""
        v: list[str] = []
        if self.sync not in SYNC_SCHEMES:
            v.append(f"unknown sync {self.sync!r}")
        if self.arch not in ARCHITECTURES:
            v.append(f"unknown arch {self.arch!r}")
        if self.schedule not in SCHEDULE_MODES:
            v.append(f"unknown schedule {self.schedule!r}")
        # Table II: an all-reduce is a synchronous collective — every worker
        # participates in the same round, so there is no ASP/SSP cell.
        if self.arch == "allreduce" and self.sync in ("asp", "ssp"):
            v.append("all-reduce is collective: incompatible with asp/ssp")
        if self.sync in ("local", "post_local") and self.local_steps < 2:
            v.append("local SGD needs local_steps >= 2")
        if self.sync == "post_local" and substrate not in (None, "trainer"):
            v.append("post_local is trainer-only (the simulators model plain local SGD)")
        if self.sync in ("ssp", "asp") and self.staleness < 1:
            v.append("ssp/asp need staleness >= 1")
        if self.error_feedback and self.compressor is None:
            v.append("error feedback without a compressor is a no-op")
        if self.schedule == "mgwfbp" and self.bucket_bytes <= 0:
            v.append("mgwfbp needs bucket_bytes > 0")
        if self.overlap not in OVERLAP_MODES:
            v.append(f"unknown overlap mode {self.overlap!r}")
        if self.overlap_staleness not in (0, 1):
            v.append("overlap_staleness must be 0 or 1")
        if self.microbatch < 1:
            v.append("microbatch must be >= 1")
        if self.overlap == "pipelined":
            # the pipeline restructures per-step gradient AGGREGATION: gossip
            # mixes parameters instead, and non-BSP schemes make the step-1
            # double buffer H-steps stale (meaningless)
            if self.arch == "gossip":
                v.append("pipelined overlap aggregates gradients (gossip mixes parameters)")
            if self.sync != "bsp":
                v.append("pipelined overlap needs per-step aggregation (sync must be bsp)")
        if self.wire_format not in ("dense", "compressed"):
            v.append(f"unknown wire_format {self.wire_format!r}")
        elif self.wire_format == "compressed":
            if self.arch == "gossip":
                v.append("compressed wire formats shape gradient aggregation "
                         "(gossip mixes parameters)")
            if (self.compressor is not None
                    and self.compressor not in WIRE_REDUCE_FAMILIES):
                v.append(f"compressor {self.compressor!r} has no "
                         "compressed-domain reduction (sign/terngrad/"
                         "qsgd families only)")
        # pod-local is BSP inside each pod by construction; the loose outer
        # boundary is the Local-SGD axis — stale schemes don't compose.
        if self.pod_local and self.sync not in ("bsp", "local"):
            v.append("pod_local forces BSP inside pods (sync must be bsp/local)")
        if not 0.0 <= self.dropout_rate < 1.0:
            v.append("dropout_rate must be in [0, 1) (1.0 would kill every worker)")
        if self.worker_dropout:
            if len(self.worker_dropout) != self.n_workers:
                v.append("worker_dropout length must equal n_workers")
            if any(not 0.0 <= p <= 1.0 for p in self.worker_dropout):
                v.append("worker_dropout probabilities must be in [0, 1]")
            if all(p >= 1.0 for p in self.worker_dropout):
                v.append("worker_dropout must leave at least one worker alive")
        if self.worker_speeds:
            if len(self.worker_speeds) != self.n_workers:
                v.append("worker_speeds length must equal n_workers")
            if any(s <= 0 for s in self.worker_speeds):
                v.append("worker_speeds must be positive multipliers")
        if self.straggler_dist not in ("lognormal", "uniform", "none"):
            v.append(f"unknown straggler_dist {self.straggler_dist!r}")
        if self.churn:
            if self.churn_start < 0:
                v.append("churn_start must be >= 0")
            if self.churn_end != -1 and self.churn_end <= self.churn_start:
                v.append("churn_end must be -1 (open) or > churn_start")
        if self.rejoin_policy not in ("reset", "pull_avg"):
            v.append(f"unknown rejoin_policy {self.rejoin_policy!r} "
                     "(expected 'reset' or 'pull_avg')")
        if self.corruption_kind not in ("none", "nan", "inf", "spike",
                                        "bitflip"):
            v.append(f"unknown corruption_kind {self.corruption_kind!r}")
        if not 0.0 <= self.corruption_rate < 1.0:
            v.append("corruption_rate must be in [0, 1)")
        if self.corruption_rate > 0 and self.corruption_kind == "none":
            v.append("corruption_rate > 0 needs a corruption_kind")
        if self.quarantine_limit < 1:
            v.append("quarantine_limit must be >= 1")
        if self.n_workers < 2:
            v.append("need >= 2 workers for a distributed scenario")
        if substrate is not None:
            if substrate not in SUBSTRATES:
                v.append(f"unknown substrate {substrate!r}")
            if substrate == "trainer" and self.sync in SIMULATE_ONLY_SYNC:
                v.append(f"{self.sync} is simulate-only (no SPMD realization)")
            if substrate == "trainer" and self.arch == "ps":
                v.append("the mesh runtime has no parameter server (simulate-only)")
            if substrate not in ("trainer",) and self.overlap == "pipelined":
                v.append("the overlap axis is runtime-only (the schedule "
                         "substrate models it via schedule='pipelined')")
            if substrate not in ("trainer",) and self.wire_format == "compressed":
                v.append("the wire_format axis is runtime-only (the "
                         "simulators model wire width analytically)")
            if substrate == "training" and self.arch == "gossip" and self.sync != "bsp":
                v.append("gossip training is a synchronous mixing round (sync must be bsp)")
            if self.churn and substrate not in ("training", "trainer", "timeline"):
                v.append("the churn axis runs on the executable substrates "
                         "(training/trainer) and the timeline event stream")
            if self._corruption_active and substrate == "trainer":
                if self.arch == "gossip":
                    v.append("trainer gossip corruption is unimplemented "
                             "(the engine models the corrupted mixing row; "
                             "the mesh gossip exchange carries no per-peer "
                             "payload hook yet)")
                if self.compressor == "powersgd":
                    v.append("powersgd's wire is a pair of factor psums — "
                             "no per-worker payload to corrupt in-domain")
            if self.worker_speeds and substrate not in (None, "timeline"):
                v.append("worker_speeds shape the timeline substrate only")
        return v

    def is_valid(self, substrate: str | None = None) -> bool:
        return not self.violations(substrate)


_FIELDS = {f.name for f in fields(Scenario)}


def grid(**axes) -> list[Scenario]:
    """Cross-product of axis value lists into the RAW scenario list.

    Each keyword is a Scenario field name mapped to one value or a list of
    values: ``grid(sync=["bsp", "local"], arch=["ps", "allreduce"])`` -> 4
    scenarios. No validity filtering — see :func:`expand`.
    """
    for name in axes:
        if name not in _FIELDS:
            raise KeyError(f"unknown Scenario field {name!r}; known: {sorted(_FIELDS)}")
    names = list(axes)
    # compressor_kwargs / worker_dropout / worker_speeds are themselves
    # tuple-valued: a LIST is an axis of values, anything else (dict, tuple)
    # is ONE value — a bare tuple must not be exploded into an axis.
    _TUPLE_VALUED = ("compressor_kwargs", "worker_dropout", "worker_speeds")
    value_lists = [
        (list(vs) if isinstance(vs, list) else [vs])
        if name in _TUPLE_VALUED
        else (list(vs) if isinstance(vs, (list, tuple)) else [vs])
        for name, vs in axes.items()
    ]
    out = []
    for combo in itertools.product(*value_lists):
        out.append(Scenario(**dict(zip(names, combo))))
    return out


def expand(
    axes_or_scenarios,
    *,
    substrate: str | None = None,
    on_invalid: str = "drop",  # drop | error | keep
    **axes,
) -> list[Scenario]:
    """Grid expansion + validity filtering in one call.

    Accepts either a ready scenario list or grid axes (as the first positional
    dict or as keywords). Invalid cells are dropped by default; ``error``
    raises listing every violation; ``keep`` returns them anyway (for tests
    that probe the filter itself).
    """
    if axes_or_scenarios is None:
        scenarios = grid(**axes)
    elif isinstance(axes_or_scenarios, dict):
        scenarios = grid(**{**axes_or_scenarios, **axes})
    else:
        scenarios = list(axes_or_scenarios)
        if axes:
            raise TypeError("pass either a scenario list or grid axes, not both")
    if on_invalid == "keep":
        return scenarios
    valid, bad = [], []
    for s in scenarios:
        v = s.violations(substrate)
        (valid if not v else bad).append((s, v))
    if bad and on_invalid == "error":
        msg = "; ".join(f"{s.tag()}: {', '.join(v)}" for s, v in bad)
        raise ValueError(f"invalid scenarios: {msg}")
    return [s for s, _ in valid]
