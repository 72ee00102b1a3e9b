"""End-to-end micro-training benchmark of the port (the twin of
``benchmarks/train_micro.py``): the per-step wall time of a reduced model
under each of nine taxonomy cells (the system-level counterpart of Table
IV), with the per-step wire bytes booked by the bundle and the kernel
launches of each cell; then the 16-cell trainer-lane acceptance sweep (2
sync schemes x 2 compressor families x 4 knob values = 4 shape classes),
asserting that the bundle registry builds at most one bundle per class and
that the class-shared builds reproduce the per-cell ones' losses.

    PYTHONPATH=src python -m repro_torch.benchmarks.train_micro [--device cpu] [--out PATH]

The reference runs its cells on 2 forced host devices; here the 2 workers
are stacked on ``--device`` (default cuda).  The record goes to
``BENCH_torch_trainer.json`` at the repository root (or ``--out``) with the
device it was measured on; the reference's ``BENCH_trainer.json`` is never
written.  Both parts run under deterministic algorithms.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.benchmarks.common import (
    ROOT,
    Row,
    deterministic,
    table_main,
    time_fn,
    write_record,
)

BENCH_PATH = ROOT / "BENCH_torch_trainer.json"
#: the reference's data shards with forced host devices
WORKERS = 2
#: timed steps of a cell after its first
REPS = 4


def micro_cells(device: str | torch.device = "cuda") -> list[dict]:
    """The nine cells, each on a fresh copy of one seeded parameter tree:
    one warm step, then ``REPS`` timed ones.  Each dict has the cell's tag,
    CommConfig, bundle, median ``us`` per step, booked wire and formats of
    one step, the steps run and the kernel launches they made."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.types import CommConfig
    from repro_torch.data.pipeline import SyntheticBatches
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.optimizers import momentum_sgd
    from repro_torch.train.steps import build_bundle
    from repro_torch.utils.tree import tree_map

    device = torch.device(device)
    cfg = get_config("qwen3-0.6b").reduced().with_updates(
        vocab=256, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, n_layers=2)
    shape = InputShape("bench", 64, 8, "train")
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in SyntheticBatches(cfg, shape).batch(0).items()}
    params = init_params(cfg, 0, device)
    cells = [
        ("dense_bsp", CommConfig()),
        ("qsgd16", CommConfig(compressor="qsgd", compressor_kwargs={"levels": 16})),
        ("topk1pct_ef", CommConfig(compressor="topk", compressor_kwargs={"ratio": 0.01},
                                   error_feedback=True)),
        ("signsgd_mv", CommConfig(compressor="signsgd")),
        ("signsgd_cwire", CommConfig(compressor="signsgd", wire_format="compressed")),
        ("qsgd16_cwire", CommConfig(compressor="qsgd", compressor_kwargs={"levels": 16},
                                    wire_format="compressed")),
        ("topk_bucketed", CommConfig(compressor="topk", compressor_kwargs={"ratio": 0.01},
                                     error_feedback=True, bucket_mb=4)),
        ("gossip_dpsgd", CommConfig(aggregator="gossip")),
        ("powersgd_r4_ef", CommConfig(compressor="powersgd", compressor_kwargs={"rank": 4},
                                      error_feedback=True, bucket_mb=4)),
    ]
    out = []
    for tag, comm in cells:
        bundle = build_bundle(cfg, comm, momentum_sgd(), shape, n_workers=WORKERS,
                              device=device)
        state = bundle.init_state(tree_map(lambda p: p.detach().clone(), params))
        step = bundle.gossip_step if comm.aggregator == "gossip" else bundle.train_step
        before = dict(ops.LAUNCHES)
        us = time_fn(step, state, batch, 0.05, device=device, warmup=1, reps=REPS)
        wkey = "gossip" if comm.aggregator == "gossip" else "train"
        by_tag = bundle.wire.get(wkey, {})
        out.append({"tag": tag, "comm": comm, "bundle": bundle, "us": us,
                    "wire": by_tag.get("grad_agg", 0.0) + by_tag.get("gossip_mix", 0.0),
                    "formats": bundle.wire.get(wkey + "_formats", {}), "steps": 1 + REPS,
                    "launches": {k: v - before[k] for k, v in ops.LAUNCHES.items()
                                 if v != before[k]}})
    return out


def _row(cell: dict) -> Row:
    fmt = "+".join(f"{f}:{b / 1e3:.1f}KB" for f, b in sorted(cell["formats"].items()) if b > 0)
    return Row(f"train_micro/{cell['tag']}", cell["us"],
               f"agg_wire={cell['wire'] / 1e3:.1f}KB_per_step" + (f"_[{fmt}]" if fmt else ""))


def trainer_sweep(device: str | torch.device = "cuda") -> dict:
    """The acceptance record: :func:`measure_trainer_sweep` on the 16-cell
    matrix at W = 4, with the reference's assertions."""
    from repro_torch.experiments.trainer_substrate import measure_trainer_sweep

    rec = measure_trainer_sweep(device=device)
    # at most one build per shape class; the shared builds reproduce the
    # per-cell losses
    assert rec["builds_shared"] <= rec["n_shape_classes"], rec
    assert rec["builds_percell"] == rec["n_cells"], rec
    assert rec["max_rel_dev_loss"] < 1e-5, rec
    return rec


def run(device: str | torch.device = "cuda", out: str | None = None) -> list[Row]:
    device = torch.device(device)
    with deterministic():
        rows = [_row(c) for c in micro_cells(device)]
        rec = trainer_sweep(device)
    write_record(rec, out, BENCH_PATH, device)
    return rows + [
        Row("train_micro/trainer_sweep", rec["shared_s"] * 1e6,
            f"{rec['n_cells']} cells -> {rec['n_shape_classes']} classes, "
            f"{rec['builds_shared']} builds ({rec['cache_hits']} hits)"),
        Row("train_micro/trainer_sweep_speedup", rec["percell_s"] * 1e6,
            f"{rec['speedup']:.1f}x over {rec['builds_percell']} per-cell builds; max dev "
            f"loss={rec['max_rel_dev_loss']:.1e}"),
        Row("train_micro/claims_validated", 0.0, True),
    ]


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
