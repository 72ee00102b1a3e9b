"""The port's kernels against their compositions (the twin of
``benchmarks/kernels_bench.py``), on ``--device``, at two sizes: the
reference's N = 262,144 elements with W = 8 gathered workers, and the main
path's largest bucket (qwen3-0.6b's embedding, 155,582,464 elements).

Rows at each size:

* each single kernel: ``qsgd``, ``terngrad``, ``sign_pack``,
  ``threshold``, ``tern_pack``;
* four fused-against-composed families, the composed path being the
  reference's composition in plain torch ops around the same port kernels:
  ``sign_vote`` (the fused vote against W ``sign_unpack`` calls summed;
  asserted bitwise equal after the sign, as the reference does),
  ``tern_acc``, ``int8_acc`` and ``qsgd_ef`` (accumulate, quantize,
  dequantize); each with the reference's HBM byte model (``fused_bytes``,
  ``composed_bytes``, equal to ``BENCH_kernels.json``'s at N = 262,144),
  its time and the bytes per second it reaches against the card's 3.35
  TB/s;
* the ``qsgd`` levels resweep (4, 8, 16): levels is a value, so no
  ``nvcc`` build and no new library between levels ("0 recompiles");
* the ``wkv6`` continuity row, (B, S, H, hd) = (1, 256, 4, 64) f32, on the
  chunked tensor-core design.

Times are CUDA events over ``ITERS`` calls after a warm-up on the card (the
mean per call), the host clock's median on the CPU (no device metric).

    PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench [--device cpu] [--out PATH]

The record goes to ``BENCH_torch_kernels.json`` at the repository root (or
``--out``); the reference's ``BENCH_kernels.json`` is never written.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.benchmarks.common import (
    ROOT,
    Row,
    rows_record,
    table_main,
    time_fn,
    write_record,
)

BENCH_PATH = ROOT / "BENCH_torch_kernels.json"
N = 262_144  # the reference's size
W = 8  # gathered workers of the collective-reduce rows
LARGEST = 155_582_464  # the main path's largest bucket (qwen3-0.6b's embedding)
SIZES = (N, LARGEST)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
ITERS = 20


def kernel_us(fn, *args, device: torch.device, iters: int = ITERS) -> float:
    """Microseconds per call: on the card CUDA events around ``iters`` calls
    after two warm ones; elsewhere the host clock's median of five."""
    if device.type != "cuda":
        return time_fn(fn, *args, device=device)
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def _traffic(fused_bytes: float, composed_bytes: float) -> str:
    return f"hbm_{composed_bytes / fused_bytes:.1f}x_less_than_composed"


def inputs(n: int, device: torch.device, seed: int = 0) -> dict[str, torch.Tensor]:
    """x, e, u and the gathered payloads of every family, from one seeded
    generator on ``device``."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=device).manual_seed(seed)

    def normal():
        return torch.randn(n, generator=g, device=device)

    def uniform():
        return torch.rand(n, generator=g, device=device)

    x, e, u = normal() * 0.1, normal() * 0.05, uniform()
    packed = torch.stack([ops.sign_pack(normal()) for _ in range(W)])
    tern = torch.sign(normal()).to(torch.int8) * (uniform() < 0.5).to(torch.int8)
    codes = torch.stack([ops.qsgd_quantize(normal(), u, 16)[0] for _ in range(W)])
    return {"x": x, "e": e, "u": u, "packed": packed, "tern": tern, "codes": codes}


def families(inp: dict[str, torch.Tensor]) -> dict[str, dict]:
    """The four fused-against-composed pairs: per family the two callables
    on their arguments and the reference's HBM byte model."""
    from repro_torch.kernels import ops

    n = inp["x"].numel()
    device = inp["x"].device
    ones = torch.ones(W, device=device)
    scales = torch.linspace(0.5, 1.5, W, device=device)
    dec_w = torch.linspace(0.01, 0.02, W, device=device)
    tpacked = torch.stack([ops.tern_pack(inp["tern"]) for _ in range(W)])

    def composed_ef(g, e, u):
        a = e * 1.0 + g  # pass 1: accumulate EF
        codes, norm = ops.qsgd_quantize(a, u, 16)  # pass 2
        return codes, norm, a - ops.qsgd_dequantize(codes, norm, 16)  # pass 3

    return {
        # the wire carries the bitmap; sign_vote decodes and sums W payloads
        # in one pass.  Composed: unpack each worker's payload, then sum
        "sign_vote": dict(
            fused=(lambda p, wt: torch.sign(ops.sign_vote(p, wt, n)), (inp["packed"], ones)),
            composed=(lambda p, wt: torch.sign(sum(wt[w] * ops.sign_unpack(p[w], n)
                                                   for w in range(W))), (inp["packed"], ones)),
            fused_bytes=n * (W / 8 + 4), composed_bytes=n * (W / 8 + 8 * W + 4),
            note=f"materializes_{W}x{4 * n / 1e6:.1f}MB_unpacked"),
        # fused reads W*n/4 packed bytes; composed the int8 decode per worker
        "tern_acc": dict(
            fused=(lambda p, s: ops.tern_acc(p, s, n), (tpacked, scales)),
            composed=(lambda t, s: sum(s[w] * t.to(torch.float32) for w in range(W)),
                      (inp["tern"], scales)),
            fused_bytes=n * (W / 4 + 4), composed_bytes=n * (W + 8 * W + 4),
            note="int8_decode_per_worker"),
        "int8_acc": dict(
            fused=(lambda c, wt: ops.int8_weighted_sum(c, wt), (inp["codes"], dec_w)),
            composed=(lambda c, wt: (c.to(torch.float32) * wt[:, None]).sum(dim=0),
                      (inp["codes"], dec_w)),
            fused_bytes=n * (W + 4), composed_bytes=n * (W + 8 * W + 4),
            note=f"widens_to_{W}x{4 * n / 1e6:.1f}MB_f32"),
        "qsgd_ef": dict(
            fused=(lambda g, e, u: ops.qsgd_ef_fused(g, e, u, 16), (inp["x"], inp["e"], inp["u"])),
            composed=(composed_ef, (inp["x"], inp["e"], inp["u"])),
            fused_bytes=(3 * 4 + 1 + 4) * n, composed_bytes=8 * 4 * n,
            note="3_passes_over_4N"),
    }


def _flat(out) -> list[torch.Tensor]:
    return list(out) if isinstance(out, tuple) else [out]


def max_abs_diff(fam: dict) -> float:
    """Largest absolute difference between the fused and composed outputs
    (each as f32)."""
    f = _flat(fam["fused"][0](*fam["fused"][1]))
    c = _flat(fam["composed"][0](*fam["composed"][1]))
    return max(float((a.to(torch.float32) - b.to(torch.float32)).abs().max())
               for a, b in zip(f, c))


def measure(n: int, device: torch.device) -> tuple[list[Row], dict]:
    """Every row at size ``n`` and the record of its families."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import LIBRARY

    pre = "kernels" if n == N else f"kernels/n{n}"
    inp = inputs(n, device)
    x, u = inp["x"], inp["u"]
    rows = [
        Row(f"{pre}/qsgd", kernel_us(lambda: ops.qsgd_quantize(x, u, 16), device=device),
            f"{4 * n / 1e6:.1f}MB_read_{n / 1e6:.1f}MB_write"),
        Row(f"{pre}/terngrad", kernel_us(lambda: ops.terngrad_quantize(x, u), device=device),
            "int8_payload"),
        Row(f"{pre}/sign_pack", kernel_us(lambda: ops.sign_pack(x), device=device), "32x_wire"),
        Row(f"{pre}/threshold", kernel_us(lambda: ops.threshold_sparsify(x, 0.05),
                                          device=device), "fused_mask+count"),
        Row(f"{pre}/tern_pack", kernel_us(lambda: ops.tern_pack(inp["tern"]), device=device),
            "16x_wire_vs_f32"),
    ]
    record: dict = {"n": n, "workers": W, "families": {}}
    for name, fam in families(inp).items():
        tf, tc = fam["fused_bytes"], fam["composed_bytes"]
        if name == "sign_vote":  # the reference's one bitwise assertion
            f = fam["fused"][0](*fam["fused"][1])
            assert torch.equal(f, fam["composed"][0](*fam["composed"][1])), name
        us_f = kernel_us(fam["fused"][0], *fam["fused"][1], device=device)
        us_c = kernel_us(fam["composed"][0], *fam["composed"][1], device=device)
        rows.append(Row(f"{pre}/{name}_fused", us_f, _traffic(tf, tc)))
        rows.append(Row(f"{pre}/{name}_composed", us_c, fam["note"]))
        rec = {"fused_us": us_f, "composed_us": us_c, "fused_bytes": tf, "composed_bytes": tc,
               "max_abs_diff": max_abs_diff(fam)}
        if name == "sign_vote":
            rec["bitwise_equal"] = True
        if device.type == "cuda":
            for side, b, us in (("fused", tf, us_f), ("composed", tc, us_c)):
                rec[f"{side}_gb_per_s"] = b / (us * 1e-6) / 1e9
                rec[f"{side}_share_of_hbm"] = b / (us * 1e-6) / HBM_BYTES_PER_S
        record["families"][name] = rec

    # levels is a value: no nvcc build and no new library between levels
    ops.qsgd_quantize(x, u, 16)
    before = (LIBRARY.nvcc_builds(), len(LIBRARY.records))
    sweep_us = {lv: kernel_us(lambda lv=lv: ops.qsgd_quantize(x, u, lv), device=device)
                for lv in (4, 8, 16)}
    after = (LIBRARY.nvcc_builds(), len(LIBRARY.records))
    recompiles = (after[0] - before[0]) + (after[1] - before[1])
    assert recompiles == 0, f"levels resweep built {recompiles} libraries"
    rows.append(Row(f"{pre}/qsgd_levels_resweep", sum(sweep_us.values()) / len(sweep_us),
                    f"levels=4,8,16_{recompiles}_recompiles"))
    record["qsgd_levels_resweep"] = {"us_per_level": {str(k): v for k, v in sweep_us.items()},
                                     "recompiles": recompiles}
    return rows, record


def wkv6_row(device: torch.device) -> Row:
    """The continuity row: (1, 256, 4, 64) f32, on the chunked design."""
    from repro_torch.kernels import ops

    B, S, H, hd = 1, 256, 4, 64
    g = torch.Generator(device=device).manual_seed(3)
    r, k, v = (torch.randn((B, S, H, hd), generator=g, device=device) * 0.3 for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, hd), generator=g, device=device)) * 0.5 + 0.4
    uu = torch.randn((H, hd), generator=g, device=device) * 0.1
    s0 = torch.zeros((B, H, hd, hd), device=device)
    us = kernel_us(lambda: ops.wkv6(r, k, v, w, uu, s0), device=device)
    flops = 4 * B * S * H * hd * hd * 2
    return Row("kernels/wkv6_chunked", us, f"{flops / 1e6:.0f}MFLOP_chunked_tensor_core")


def run(device: str | torch.device = "cuda", out: str | None = None,
        sizes: tuple[int, ...] = SIZES) -> list[Row]:
    from repro_torch.kernels import ops

    device = torch.device(device)
    before = dict(ops.LAUNCHES)
    rows: list[Row] = []
    record: dict = {"n": N, "workers": W, "sizes": {}}
    for n in sizes:
        size_rows, rec = measure(n, device)
        rows += size_rows
        record["sizes"][str(n)] = rec
        if n == N:
            record["families"] = rec["families"]
            record["qsgd_levels_resweep"] = rec["qsgd_levels_resweep"]
    rows.append(wkv6_row(device))
    record["launches"] = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
    record["rows"] = rows_record(rows)
    write_record(record, out, BENCH_PATH, device)
    rows.append(Row("kernels/claims_validated", 0.0, True))
    return rows


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
