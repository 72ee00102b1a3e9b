"""Communication configuration (counterpart of ``repro.core.types``).

:class:`CommConfig` keeps every field and default of the reference, so a
cell description reads the same in both packages.  The port runs the
trainer under BSP, local SGD and post-local SGD (``sync``) and pod-local
SGD (``pod_local``: BSP inside each pod, parameter averaging across pods),
with sequential or microbatch-pipelined overlap (``overlap``, staleness 0
or 1, ``stale_scale``), over the all-reduce or ring gossip
(``aggregator``: D-PSGD, or CHOCO-SGD with ``gossip_compress="choco"``),
with momentum correction,
local clipping and error feedback (with decay) on every registered
compressor, over the dense wire (an f32 or bf16 all-reduce by the ``xla``,
``ring`` or ``rhd`` schedule, int8 majority vote, gather-and-decompress,
the sparse scatter-add, the sum of masked payloads, PowerSGD's factor
psums) or the compressed wire (int8 codes, 1-bit signs, 2-bit ternary
codes, the bf16 widening psum).  ``warmup_steps`` and ``gossip_graph`` are
accepted and, as in the reference's runtime, read by nothing (the gossip
ring is always the ring), with churn (a per-round participation mask drawn
per worker: ``churn``, ``dropout_rate`` or ``worker_dropout`` inside the
step window [``churn_start``, ``churn_end``), rejoin by ``reset`` or
``pull_avg``) and gradient integrity (in-domain corruption of the wire
payload by ``corruption_kind`` at ``corruption_rate``, validation,
quarantine, and escalation after ``quarantine_limit`` consecutive
quarantined rounds).  :func:`validate` applies the reference's
``bundle_spec`` checks on those fields and on ``overlap``,
``overlap_staleness``, ``wire_format`` and ``agg_dtype``;
:func:`effective_corruption_kind` and :func:`churn_enabled` are the
reference's structural rules for the two axes.  :func:`bundle_spec`
projects a config onto its structural half (:class:`BundleSpec`), the key
of the trainer's shape classes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class CommConfig:
    # --- compression ---------------------------------------------------------
    compressor: str = "none"
    compressor_kwargs: dict[str, Any] = field(default_factory=dict)
    per_tensor_rules: list = field(default_factory=list)

    # --- auxiliary technologies ----------------------------------------------
    error_feedback: bool = False
    ef_decay: float = 1.0
    momentum_correction: float = 0.0
    local_clip: float = 0.0
    warmup_steps: int = 0

    # --- synchronization -------------------------------------------------------
    sync: str = "bsp"
    local_steps: int = 1
    post_local_switch: int = 0
    pod_local: bool = False

    # --- architecture / collectives ---------------------------------------------
    aggregator: str = "allreduce"
    collective: str = "xla"
    gossip_graph: str = "ring"
    gossip_compress: str = "none"
    gossip_step_size: float = 0.5
    gossip_mix_weight: float = 1.0 / 3.0

    # --- scheduling --------------------------------------------------------------
    bucket_mb: float = 0.0
    agg_dtype: str = "float32"
    overlap: str = "sequential"
    overlap_staleness: int = 1
    stale_scale: float = 1.0

    # --- wire format ---------------------------------------------------------------
    wire_format: str = "dense"

    # --- churn / elastic workers -----------------------------------------------------
    churn: bool = False
    dropout_rate: float = 0.0
    worker_dropout: tuple = ()
    churn_start: int = 0
    churn_end: int = -1
    rejoin_policy: str = "reset"

    # --- gradient integrity ------------------------------------------------------------
    corruption_rate: float = 0.0
    corruption_kind: str = "none"
    quarantine_limit: int = 3

    def with_updates(self, **kw) -> "CommConfig":
        return dataclasses.replace(self, **kw)


DENSE = CommConfig()


def churn_enabled(comm: CommConfig) -> bool:
    """Whether the masked (churn) program is on: an explicit ``churn``, a
    positive ``dropout_rate``, any positive ``worker_dropout`` rate or a
    positive ``corruption_rate`` (the reference's ``bundle_spec`` rule)."""
    return bool(comm.churn or comm.dropout_rate > 0
                or any(r > 0 for r in comm.worker_dropout)
                or comm.corruption_rate > 0)


def effective_corruption_kind(comm: CommConfig) -> str:
    """The structural corruption family: the kind when the rate is positive,
    or when an explicit ``churn=True`` keeps a rate-0 cell in the integrity
    program; "none" otherwise."""
    if comm.corruption_rate > 0 or (comm.churn and comm.corruption_kind != "none"):
        return comm.corruption_kind
    return "none"


def _validate_churn(comm: CommConfig) -> None:
    """The reference's ``bundle_spec`` checks on the churn and integrity
    fields (each message names the field)."""
    churn = churn_enabled(comm)
    if comm.rejoin_policy not in ("reset", "pull_avg"):
        raise ValueError(f"unknown rejoin_policy {comm.rejoin_policy!r} "
                         "(expected 'reset' or 'pull_avg')")
    if churn and not 0.0 <= comm.dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {comm.dropout_rate!r}")
    if churn and not all(0.0 <= r < 1.0 for r in comm.worker_dropout):
        raise ValueError(f"worker_dropout rates must be in [0, 1), got {comm.worker_dropout!r}")
    if comm.corruption_kind not in ("none", "nan", "inf", "spike", "bitflip"):
        raise ValueError(f"unknown corruption_kind {comm.corruption_kind!r} "
                         "(expected 'none', 'nan', 'inf', 'spike' or 'bitflip')")
    if comm.corruption_rate > 0 and comm.corruption_kind == "none":
        raise ValueError("corruption_rate > 0 needs a corruption_kind")
    if not 0.0 <= comm.corruption_rate < 1.0:
        raise ValueError(f"corruption_rate must be in [0, 1), got {comm.corruption_rate!r}")
    if comm.quarantine_limit < 1:
        raise ValueError(f"quarantine_limit must be >= 1, got {comm.quarantine_limit!r}")


def validate(comm: CommConfig):
    """Check ``comm`` for the port and return its compressor (or None).

    Raises ``ValueError`` where the reference's ``bundle_spec`` does: on the
    churn and integrity fields (:func:`_validate_churn`), ``overlap``,
    ``overlap_staleness`` (pipelined overlap needs per-step aggregation: BSP, unless the cell gossips, which
    reads neither), ``wire_format`` and ``agg_dtype`` (a gossip cell's wire
    is dense whatever it says, as there), and for a ``sync``,
    ``aggregator``, ``gossip_compress`` or ``collective`` that is none of
    the reference's."""
    from repro_torch.core.compression.base import get_compressor

    _validate_churn(comm)
    for name, allowed in (("sync", ("bsp", "local", "post_local")),
                          ("aggregator", ("allreduce", "gossip")),
                          ("gossip_compress", ("none", "dcd", "choco"))):
        if getattr(comm, name) not in allowed:
            raise ValueError(f"unknown {name} {getattr(comm, name)!r} (expected one of "
                             f"{allowed})")
    if comm.overlap not in ("sequential", "pipelined"):
        raise ValueError(f"unknown overlap mode {comm.overlap!r}")
    if comm.overlap_staleness not in (0, 1):
        raise ValueError(f"overlap_staleness must be 0 or 1, got {comm.overlap_staleness!r}")
    if comm.overlap == "pipelined" and comm.aggregator != "gossip" and comm.sync != "bsp":
        # the double buffer is refilled only by the aggregating step: under
        # local / post-local SGD its contribution would be H steps old
        raise ValueError("pipelined overlap needs per-step aggregation (sync must be bsp, "
                         f"got {comm.sync!r})")
    if comm.collective not in ("xla", "ring", "rhd"):
        raise ValueError(f"unknown collective {comm.collective!r} (expected 'xla', 'ring' "
                         "or 'rhd')")
    comp = get_compressor(comm.compressor, **comm.compressor_kwargs)
    if comm.wire_format not in ("dense", "compressed"):
        raise ValueError(f"unknown wire_format {comm.wire_format!r}")
    gossip = comm.aggregator == "gossip"
    if comm.wire_format == "compressed" and not gossip:
        if comp is not None and not getattr(comp, "wire_reduce", ""):
            raise ValueError(
                f"wire_format='compressed' is unsupported for compressor "
                f"{comm.compressor!r}: no compressed-domain reduction")
        if comm.agg_dtype == "bfloat16" and comp is not None:
            raise ValueError(
                "agg_dtype='bfloat16' only shapes the dense aggregation "
                "path — meaningless combined with a compressed wire format")
    if gossip:  # gossip mixes parameters: no gradient reduction runs
        return comp
    from repro_torch.core.aggregate import bucket_route

    # NotImplementedError for an unported reduction, of any bucket's compressor
    bucket_route(comm, comp)
    for _, name, kwargs in comm.per_tensor_rules:
        bucket_route(comm, get_compressor(name, **kwargs))
    return comp


@dataclass(frozen=True)
class BundleSpec:
    """The structural half of a :class:`CommConfig` (the reference's
    ``BundleSpec``): two configs with equal specs run the same step programs
    and book the same wire; they differ only in value knobs (compressor
    runtime knobs such as qsgd's levels, ``ef_decay``, ``stale_scale``,
    churn rates and windows, ``corruption_rate``, gossip weights), which
    each cell binds itself.  ``comp_key`` is the compressor's
    ``runtime_fingerprint``; inert knobs are normalized so that they never
    split a class (``overlap`` for gossip, ``overlap_staleness`` for
    sequential cells, ``rejoin_policy`` for churn-free ones, the wire format
    for gossip)."""

    sync: str
    pod_local: bool
    aggregator: str
    collective: str
    gossip_graph: str
    gossip_compress: str
    error_feedback: bool
    momentum_correction: bool
    local_clip: bool
    warmup_steps: int
    comp_key: tuple
    rules_key: tuple
    bucket_mb: float
    agg_dtype: str
    overlap: str = "sequential"
    overlap_staleness: int = 0
    churn: bool = False
    rejoin_policy: str = "reset"
    wire_format: str = "dense"
    corruption_kind: str = "none"


def bundle_spec(comm: CommConfig) -> BundleSpec:
    """Project ``comm`` onto its structural half, after :func:`validate`'s
    checks (the reference's ``bundle_spec`` raises on the same fields).
    ``local_steps``, ``post_local_switch`` (the trainer's step-count
    decisions) and every value knob are absent."""
    from repro_torch.core.compression.base import runtime_fingerprint

    comp = validate(comm)
    gossip = comm.aggregator == "gossip"
    churn = churn_enabled(comm)
    return BundleSpec(
        sync=comm.sync,
        pod_local=bool(comm.pod_local),
        aggregator=comm.aggregator,
        collective=comm.collective,
        gossip_graph=comm.gossip_graph,
        gossip_compress=comm.gossip_compress,
        error_feedback=bool(comm.error_feedback),
        momentum_correction=bool(comm.momentum_correction),
        local_clip=bool(comm.local_clip),
        warmup_steps=int(comm.warmup_steps),
        comp_key=runtime_fingerprint(comp),
        rules_key=tuple((sub, name, tuple(sorted(dict(kw).items())))
                        for sub, name, kw in comm.per_tensor_rules),
        bucket_mb=float(comm.bucket_mb),
        agg_dtype=comm.agg_dtype,
        overlap=comm.overlap if not gossip else "sequential",
        overlap_staleness=(int(comm.overlap_staleness)
                           if comm.overlap == "pipelined" and not gossip else 0),
        churn=churn,
        rejoin_policy=comm.rejoin_policy if churn else "reset",
        wire_format=comm.wire_format if not gossip else "dense",
        corruption_kind=effective_corruption_kind(comm),
    )
