"""Comparison-table emission for scenario sweeps (paper Table II/IV style;
the port's own copy of ``repro.experiments.tables``).

``format_table`` renders a list of :class:`ScenarioResult` as a markdown
table with the measured metrics and the cost-model predictions side by
side; ``format_csv`` emits the same rows machine-readably.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.experiments.runner import ScenarioResult

#: (column header, measured key, predicted key or None) per substrate —
#: predicted columns render next to their measured counterpart.
_COLUMNS = {
    "timeline": (
        ("iter_time(s)", "iter_time", "iter_time"),
        ("throughput(it/s)", "throughput", "throughput"),
        ("comm_frac", "comm_frac", "comm_frac"),
        ("GB/worker", "bytes_per_worker", "bytes_per_worker"),
        ("staleness", "mean_staleness", None),
        ("idle_frac", "idle_frac", None),
    ),
    "training": (
        ("final_loss", "final_loss", None),
        ("x*_err", "x_star_err", None),
        ("consensus", "consensus", None),
        ("Gbits", "gbits", None),
        ("bits/elem", None, "bits_per_element"),
        ("compress_x", None, "compression_x"),
    ),
    "schedule": (
        ("iter_time(ms)", "iter_time", None),
        ("comm_time(ms)", "comm_time", None),
        ("saving(ms)", "overlap_saving", None),
        ("messages", "n_messages", None),
        ("no_overlap(ms)", None, "no_overlap_time"),
        ("overlap_bound(ms)", None, "full_overlap_bound"),
    ),
    "trainer": (
        ("final_loss", "final_loss", None),
        ("step(ms)", "step_time_s", None),
        ("KB/step", "wire_kb_per_step", None),
        ("saving(ms)", "overlap_saving_s", "overlap_saving_s"),
        ("sync_rounds", "sync_rounds", None),
    ),
    "roofline": (
        ("compute(ms)", "t_compute", None),
        ("memory(ms)", "t_memory", None),
        ("collective(ms)", "t_collective", None),
        ("bound(ms)", "iter_time_bound", None),
        ("bottleneck", "bottleneck", None),
        ("alphabeta_iter(s)", None, "iter_time"),
    ),
}

#: the training table's integrity columns, shown when a cell books them
_INTEGRITY_COLUMNS = (
    ("quarantined", "quarantine_rounds", None),
    ("q_Gbits", "quarantined_gbits", None),
    ("escalations", "escalations", None),
)

_SCALE = {"GB/worker": 1e-9, "iter_time(ms)": 1e3, "comm_time(ms)": 1e3,
          "no_overlap(ms)": 1e3, "overlap_bound(ms)": 1e3, "saving(ms)": 1e3,
          "step(ms)": 1e3, "compute(ms)": 1e3, "memory(ms)": 1e3,
          "collective(ms)": 1e3, "bound(ms)": 1e3}


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1000 or abs(v) < 0.01:
            return f"{v:.3g}"
        return f"{v:.3f}"
    return str(v)


def format_table(results: Sequence[ScenarioResult], *, title: str = "") -> str:
    """Markdown table, one row per scenario. Measured/predicted pairs are
    rendered as ``measured (pred)`` in one column; a training table whose
    cells book integrity tallies adds their three columns."""
    if not results:
        return "(no scenarios)\n"
    substrate = results[0].substrate
    cols = _COLUMNS.get(substrate, ())
    if any("quarantine_rounds" in r.measured for r in results):
        cols = cols + _INTEGRITY_COLUMNS
    header = ["scenario"] + [c[0] for c in cols]
    lines = []
    if title:
        lines.append(f"## {title}")
        lines.append("")
    lines.append("| " + " | ".join(header) + " |")
    lines.append("|" + "|".join("---" for _ in header) + "|")
    for r in results:
        tag = r.tag
        if substrate == "schedule":
            tag = f"{r.scenario.layer_profile}/{tag}"
        cells = [tag]
        for name, mk, pk in cols:
            scale = _SCALE.get(name, 1.0)
            m = r.measured.get(mk) if mk else None
            p = r.predicted.get(pk) if pk else None
            m = m * scale if isinstance(m, (int, float)) and mk else m
            p = p * scale if isinstance(p, (int, float)) and pk else p
            if m is not None and p is not None:
                cells.append(f"{_fmt(m)} ({_fmt(p)})")
            else:
                cells.append(_fmt(m if m is not None else p))
        lines.append("| " + " | ".join(cells) + " |")
    legend = "measured (cost-model prediction)" if any(c[1] and c[2] for c in cols) else ""
    if legend:
        lines.append("")
        lines.append(f"*cells: {legend}*")
    return "\n".join(lines) + "\n"


def format_csv(results: Sequence[ScenarioResult]) -> str:
    if not results:
        return ""
    rows = [r.row() for r in results]
    keys = sorted({k for row in rows for k in row}, key=lambda k: (k != "tag", k))
    lines = [",".join(keys)]
    for row in rows:
        lines.append(",".join(_fmt(row.get(k)) for k in keys))
    return "\n".join(lines) + "\n"
