"""Analytic communication cost models (paper Tables III & IV; counterpart
of ``repro.core.costmodel``, plain Python).

The alpha-beta model: sending an N-element f32 vector costs
``alpha + beta * 4N`` seconds [149].  Table III gives the all-reduce
algorithm costs; Table IV the per-iteration upload complexity of each
(architecture x sync x compression) cell.  :mod:`repro_torch.core.schedule`
prices its messages with them.
"""

from __future__ import annotations

from dataclasses import dataclass
import math


@dataclass(frozen=True)
class Link:
    alpha: float = 1e-5  # latency per message (s) — ICI-class
    beta: float = 1.0 / 50e9  # seconds per byte (~50 GB/s per link)


# --------------------------- Table III ------------------------------------


def allreduce_cost(alg: str, n: int, nbytes: float, link: Link = Link()) -> float:
    """Latency+bandwidth cost of one all-reduce of `nbytes` over n workers."""
    a, b = link.alpha, link.beta
    if n <= 1:
        return 0.0
    if alg == "binary_tree":
        return 2 * a * math.log2(n) + 2 * b * math.log2(n) * nbytes
    if alg == "recursive_doubling":
        return a * math.log2(n) + b * math.log2(n) * nbytes
    if alg == "ring":
        return 2 * (n - 1) * a + 2 * (n - 1) / n * b * nbytes
    if alg == "double_binary_tree":  # [148]: full bandwidth, log latency
        return 2 * a * math.log2(n) + 2 * b * nbytes
    if alg == "rhd":  # recursive halving-doubling
        return 2 * a * math.log2(n) + 2 * (n - 1) / n * b * nbytes
    if alg == "2d_torus":  # [151]: two ring phases over sqrt(n) each
        r = math.isqrt(n)
        return 4 * (r - 1) * a + 4 * (r - 1) / r * b * nbytes / 1  # 2 dims
    if alg == "hierarchical":  # [21,150]: intra (g groups) then inter
        g = math.isqrt(n)
        intra = 2 * (g - 1) * a + 2 * (g - 1) / g * b * nbytes
        inter = 2 * (n // g - 1) * a + 2 * (n // g - 1) / (n // g) * b * nbytes
        return intra + inter
    raise ValueError(alg)


TABLE_III_ALGS = (
    "binary_tree",
    "recursive_doubling",
    "ring",
    "double_binary_tree",
    "rhd",
    "2d_torus",
    "hierarchical",
)


# --------------------------- PS / gossip ----------------------------------


def ps_cost(n: int, nbytes: float, link: Link = Link(), *, congested: bool = True) -> float:
    """PS upload+download; the server link is shared by n workers when
    congested (paper §IV-A congestion problem)."""
    share = n if congested else 1
    return 2 * (link.alpha + link.beta * nbytes * share)


def gossip_cost(nbytes: float, peers: int = 2, link: Link = Link()) -> float:
    return peers * (link.alpha + link.beta * nbytes)


def round_wire_bytes(arch: str, n: int, nbytes: float, *, peers: int = 2) -> float:
    """Per-worker wire bytes of ONE synchronization round (both directions).
    The single source for byte accounting — the timeline simulator and the
    scenario engine's predictions both use it, so measured and predicted
    bytes can only diverge through dynamics, never through the formula."""
    if arch == "ps":
        return 2 * nbytes  # upload + download
    if arch == "allreduce":
        return 2 * (n - 1) / n * nbytes  # ring: reduce-scatter + all-gather
    if arch == "gossip":
        return peers * nbytes
    raise ValueError(arch)


# --------------------------- Table IV -------------------------------------


def upload_bits(
    compress: str,
    N: int,
    *,
    n_workers: int = 16,
    ratio: float = 0.01,
    levels: int = 16,
    T: int = 1,
    T_comm: int = 1,
) -> float:
    """Per-worker upload bits per `T` iterations (Table IV 'Workers' column).

    compress: none | quant | spars ; T_comm = local-SGD period.
    """
    rounds = T / T_comm
    if compress == "none":
        per = 32.0 * N
    elif compress == "quant":
        per = (math.log2(levels) + 1) * N
    elif compress == "spars":
        k = max(1, int(N * ratio))
        per = k * (math.ceil(math.log2(max(N, 2))) + 32)
    else:
        raise ValueError(compress)
    return per * rounds
