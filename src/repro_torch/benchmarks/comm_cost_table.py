"""Paper Table IV on the port (the twin of ``benchmarks/comm_cost_table.py``):
the per-worker communication cost of each (sync x compression) cell for
the survey's running example, a 25,000,000-parameter model (the cost
model's ``estimated_wire_bytes`` x ``rounds_per_iter``), and the payload
bytes of ten real wire formats on a 1,000,000-element bucket, compressed
on ``--device``.  Asserts the table's ordering (sparsified below quantized
below dense per iteration, local SGD below BSP, every format below 4
bytes an element); like the reference's module it prints no claims row.

    PYTHONPATH=src python -m repro_torch.benchmarks.comm_cost_table [--device cpu] [--out PATH]

The bucket is 1,000,000 standard normals from a seeded ``torch.Generator``
on the device (the reference draws with ``jax.random``; every format's size
depends on n alone, so the bytes are the reference's).  The record goes to
``BENCH_torch_comm_cost.json`` at the repository root (or ``--out``).
"""

from __future__ import annotations

import sys
from typing import Callable

import torch

from repro_torch.benchmarks.common import ROOT, Row, rows_record, table_main, write_record
from repro_torch.core.compression import get_compressor
from repro_torch.core.compression.base import needs_noise, noise_len
from repro_torch.experiments import Scenario
from repro_torch.experiments.runner import estimated_wire_bytes, rounds_per_iter

BENCH_PATH = ROOT / "BENCH_torch_comm_cost.json"
N = 25_000_000  # the survey's running example: a 25M-parameter model
#: the measured bucket's elements
BUCKET = 1_000_000
#: the wire formats whose payloads are measured
FORMATS = (
    ("qsgd", {"levels": 16}), ("terngrad", {}), ("signsgd", {}),
    ("signsgd_packed", {}), ("onebit", {}), ("natural", {}),
    ("topk", {"ratio": 0.001}), ("gtopk", {"ratio": 0.001}),
    ("stc", {"ratio": 0.001}), ("sbc", {"ratio": 0.001}),
)


def analytic_rows() -> list[Row]:
    """The cost model's rows; asserts the table's ordering (the reference's
    module prints no claims row, so none is added): sparsified below
    quantized below dense, local SGD below BSP."""
    rows: list[Row] = []
    dense_bytes = 4.0 * N
    per = {}
    for sync, H in (("bsp", 1), ("local_sgd_H8", 8)):
        for comp, kw in ((None, {}), ("qsgd", {"levels": 16}), ("topk", {"ratio": 0.001})):
            s = Scenario(sync="local" if H > 1 else "bsp", local_steps=max(H, 2),
                         compressor=comp, compressor_kwargs=kw, msg_bytes=dense_bytes)
            per_iter = estimated_wire_bytes(s) * rounds_per_iter(s)
            name = {None: "none", "qsgd": "quant", "topk": "spars"}[comp]
            per[(sync, name)] = per_iter
            rows.append(Row(f"tableIV/{sync}/{name}", 0.0,
                            f"{per_iter/1e6:.2f}MB_per_iter_x{dense_bytes/per_iter:.0f}"))
    for sync in ("bsp", "local_sgd_H8"):
        assert per[(sync, "spars")] < per[(sync, "quant")] < per[(sync, "none")], per
    for name in ("none", "quant", "spars"):
        assert per[("local_sgd_H8", name)] < per[("bsp", name)], per
    return rows


def bucket(device: str | torch.device = "cuda", n: int = BUCKET) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randn(n, generator=g, device=device)


def payload_bytes(x: torch.Tensor, noise: Callable | None = None) -> dict[str, int]:
    """Payload bytes of each wire format on ``x``.  ``noise(name, k)`` gives
    a stochastic compressor its k uniforms (default: a generator seeded 1
    on ``x``'s device)."""
    out = {}
    for name, kw in FORMATS:
        comp = get_compressor(name, **kw)
        u = None
        if needs_noise(comp):
            k = noise_len(comp, x.numel())
            if noise is None:
                g = torch.Generator(device=x.device).manual_seed(1)
                u = torch.rand(k, generator=g, device=x.device)
            else:
                u = noise(name, k)
        out[name] = comp.compress(u, x).payload_bytes()
    return out


def table(device: str | torch.device = "cuda", x: torch.Tensor | None = None,
          noise: Callable | None = None) -> list[Row]:
    rows = analytic_rows()
    x = bucket(device) if x is None else x
    for name, nbytes in payload_bytes(x, noise).items():
        ratio = 4.0 * x.numel() / nbytes
        assert ratio > 1.0, (name, nbytes)  # every wire format compresses
        rows.append(Row(f"tableIV/payload/{name}", 0.0, f"{nbytes}B_x{ratio:.0f}"))
    return rows


def run(device: str | torch.device = "cuda", out: str | None = None) -> list[Row]:
    device = torch.device(device)
    rows = table(device)
    write_record({"n_params": N, "bucket": BUCKET, "rows": rows_record(rows)}, out,
                 BENCH_PATH, device)
    return rows


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
