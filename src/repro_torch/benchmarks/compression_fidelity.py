"""Paper Fig. 6 on the port (the twin of
``benchmarks/compression_fidelity.py``): the normalized MSE and the
compression ratio of fourteen compressors, quantizers against sparsifiers,
on a bell-shaped gradient with a heavy tail ([193]: 1% of 1,000,000
elements drawn ten times wider), each compress-and-decompress roundtrip
timed on ``--device``.  Asserts the figure's claims: QSGD with 16 levels
below 4 levels, top-k below random-k at the same k.

    PYTHONPATH=src python -m repro_torch.benchmarks.compression_fidelity [--device cpu] [--out PATH]

The gradient and the compressors' uniforms come from seeded
``torch.Generator``s on the device (the reference draws with
``jax.random``; ``fidelity`` takes any other array and draws).  The record
goes to ``BENCH_torch_fidelity.json`` at the repository root (or
``--out``).
"""

from __future__ import annotations

import sys
from typing import Callable

import torch

from repro_torch.benchmarks.common import (
    ROOT,
    Row,
    rows_record,
    table_main,
    time_fn,
    write_record,
)
from repro_torch.core.compression import get_compressor
from repro_torch.core.compression.base import needs_noise, noise_len

BENCH_PATH = ROOT / "BENCH_torch_fidelity.json"
N = 1_000_000

CASES = (
    ("qsgd_s4", "qsgd", {"levels": 4}),
    ("qsgd_s16", "qsgd", {"levels": 16}),
    ("terngrad", "terngrad", {}),
    ("signsgd", "signsgd", {}),
    ("natural", "natural", {}),
    ("onebit", "onebit", {}),
    ("topk_1pct", "topk", {"ratio": 0.01}),
    ("topk_0.1pct", "topk", {"ratio": 0.001}),
    ("randomk_1pct", "randomk", {"ratio": 0.01}),
    ("wangni_1pct", "wangni", {"ratio": 0.01}),
    ("stc_1pct", "stc", {"ratio": 0.01}),
    ("sbc_1pct", "sbc", {"ratio": 0.01}),
    ("adaptive_thr_1pct", "adaptive_threshold", {"proportion": 0.01}),
    ("powersgd_r4", "powersgd", {"rank": 4}),
)


def gradients(device: str | torch.device = "cuda", n: int = N) -> torch.Tensor:
    """0.01 N(0, 1), with 1% of the elements 0.1 N(0, 1) instead."""
    g = torch.Generator(device=device).manual_seed(0)
    base = torch.randn(n, generator=g, device=device) * 0.01
    spikes = torch.randn(n, generator=g, device=device) * 0.1
    mask = torch.rand(n, generator=g, device=device) < 0.01
    return torch.where(mask, spikes, base)


def fidelity(x: torch.Tensor, *, noise: Callable | None = None,
             q0: torch.Tensor | None = None, timed: bool = True) -> dict[str, dict]:
    """Per case: ``nmse`` (mean squared roundtrip error over the mean
    square), ``ratio`` (32 bits per element over the wire bits) and ``us``
    (median roundtrip time, when ``timed``).  ``noise(tag, k)`` gives a
    stochastic compressor its k uniforms (default: a generator seeded 3 on
    ``x``'s device, the same draw for every case, as the reference's one
    key); ``q0`` is PowerSGD's initial Q (default its own draw)."""
    n = x.numel()
    out = {}
    for tag, name, kw in CASES:
        comp = get_compressor(name, **kw)
        u = None
        if needs_noise(comp):
            k = noise_len(comp, n)
            if noise is None:
                g = torch.Generator(device=x.device).manual_seed(3)
                u = torch.rand(k, generator=g, device=x.device)
            else:
                u = noise(tag, k)
        extra = {"q0": q0} if name == "powersgd" and q0 is not None else {}

        def roundtrip(v, uu, comp=comp, extra=extra):
            return comp.decompress(comp.compress(uu, v, **extra))

        us = time_fn(roundtrip, x, u, device=x.device) if timed else 0.0
        xh = roundtrip(x, u)
        nmse = float(torch.mean(torch.square(xh - x))) / float(torch.mean(torch.square(x)))
        bits = comp.wire_bits(n)
        out[tag] = {"nmse": nmse, "ratio": 32.0 * n / bits if bits == bits else float("nan"),
                    "us": us}
    return out


def table(device: str | torch.device = "cuda") -> tuple[list[Row], dict]:
    res = fidelity(gradients(device))
    rows = [Row(f"fig6/{tag}", r["us"], f"nmse={r['nmse']:.4f} ratio={r['ratio']:.0f}x")
            for tag, r in res.items()]
    # Fig. 6's claims: more levels, lower MSE; top-k beats random-k at one k
    assert res["qsgd_s16"]["nmse"] < res["qsgd_s4"]["nmse"], res
    assert res["topk_1pct"]["nmse"] < res["randomk_1pct"]["nmse"], res
    rows.append(Row("fig6/claims_validated", 0.0, True))
    return rows, res


def run(device: str | torch.device = "cuda", out: str | None = None) -> list[Row]:
    device = torch.device(device)
    rows, res = table(device)
    write_record({"n": N, "cases": res, "rows": rows_record(rows)}, out, BENCH_PATH, device)
    return rows


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
