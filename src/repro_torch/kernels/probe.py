"""Probes of what holds kernel ``wkv6``'s chunked design on the card.

    PYTHONPATH=src python -m repro_torch.kernels.probe [mma] [phases] [bwd]

``mma``: ``mma.sync`` m16n8k8 TF32 (the chunked design's products) and
m16n8k16 BF16, with one dependent chain per warp (cycles per product: the
latency) and with eight (the rate), two CTAs of four warps per SM.

``phases``: the chunked design at the server's prefill shape (8, 1024, 32,
80) bf16, timed whole and with each phase compiled out in turn (its results
are then wrong; only the times are read), so the difference is what that
phase costs; and with every phase compiled out (the staging loads and the
barriers alone).

``bwd``: wkv6_backward's two launches at the training shape (2, 1024, 32,
80) bf16 in the same way: ``wkv6_bwd_states`` and ``wkv6_bwd``, each whole,
with each of its phases compiled out in turn and with all of them.

All build with ``nvcc`` into ``kernels/_build/probe/`` and need the card.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS

OUT = BUILD_DIR / "probe"

MMA_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int KIND>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  if (KIND == 0)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <int KIND, int CH>
__global__ void chains(float* out, long long* cycles, int iters, uint32_t seed) {
  uint32_t a[4] = {seed, seed + 1, seed + 2, seed + 3}, b[2] = {seed * 3, seed * 5};
  float d[CH][4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) mma<KIND>(d[c], a, b);
  }
  const long long t1 = clock64();
  float s = 0.0f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 1234.5f) out[threadIdx.x] = s;  // keeps the products live
  if (blockIdx.x == 0 && threadIdx.x == 0) *cycles = t1 - t0;
}
extern "C" int run(int kind, int ch, int blocks, int iters, float* out, long long* cycles) {
  if (kind == 0 && ch == 1) chains<0, 1><<<blocks, 128>>>(out, cycles, iters, 1);
  if (kind == 0 && ch == 8) chains<0, 8><<<blocks, 128>>>(out, cycles, iters, 1);
  if (kind == 1 && ch == 1) chains<1, 1><<<blocks, 128>>>(out, cycles, iters, 1);
  if (kind == 1 && ch == 8) chains<1, 8><<<blocks, 128>>>(out, cycles, iters, 1);
  return static_cast<int>(cudaGetLastError());
}
"""

#: (phase, the line of csrc/wkv6.cu that runs it, the same line with the
#: phase's work removed)
PHASES = (
    ("phase 1 (prefix sums, R, K, E)",
     "    for (int e = tid; e < 2 * HD; e += kThreads) {\n      const int p = e / HD",
     "    for (int e = tid; e < 0; e += kThreads) {\n      const int p = e / HD"),
    ("2a (diagonal blocks, CUDA cores)",
     "    for (int task = warp; task < kL; task += kWarps) {",
     "    for (int task = warp; task < 0; task += kWarps) {"),
    ("2b (off-diagonal block)", "    if (warp >= kWarps - 2) {", "    if (false) {"),
    ("2c (state term)", "    for (int ks = 0; ks < CF::KS; ++ks) {\n      uint32_t ah[4], al[4], bh[CF::YW]",
     "    for (int ks = 0; ks < 0; ++ks) {\n      uint32_t ah[4], al[4], bh[CF::YW]"),
    ("3a (A V)", "    for (int ks = 0; ks < 2 * (my_m + 1); ++ks) {",
     "    for (int ks = 0; ks < 0; ++ks) {"),
    ("3b (state update)", "    for (int unit = warp; unit < CF::MT * CF::NT / 2; unit += kWarps) {",
     "    for (int unit = warp; unit < 0; unit += kWarps) {"),
)


#: the same for launch wkv6_bwd (csrc/wkv6_bwd.cu): each phase's lines end
#: in a comment that names it (a phase of several loops repeats its line,
#: and every copy is cut)
BWD_PHASES = (
    ("the D carry (backward sweep)", "unit < MT * NT / 2; unit += kWarps) {  // the D carry",
     "unit < 0; unit += kWarps) {  // the D carry"),
    ("k * sigma and E", "if (tid >= kThreads - HD) {  // k * sigma, E",
     "if (false) {  // k * sigma, E"),
    ("the scores A (CUDA cores)", "for (int i = lane; i < HD; i += 32) {  // the scores",
     "for (int i = lane; i < 0; i += 32) {  // the scores"),
    ("M, PD, GV (tensor cores)", "for (int ks = 0; ks < KS; ++ks) {  // M, PD, GV",
     "for (int ks = 0; ks < 0; ++ks) {  // M, PD, GV"),
    ("rowsum(P * D)", "if (warp < HD) {  // rowsum(P * D)", "if (false) {  // rowsum(P * D)"),
    ("dv (tensor cores)", "for (int job = warp; job < NT; job += kWarps) {  // dv",
     "for (int job = warp; job < 0; job += kWarps) {  // dv"),
    ("dr's group", "if (grp == 0) {  // dr", "if (false) {  // dr"),
    ("dk's group", "if (grp == 1) {  // dk", "if (false) {  // dk"),
    ("dw's last term's group", "if (grp == 2) {  // dw's last term",
     "if (false) {  // dw's last term"),
    ("the P carry", "unit < MT * NT / 2; unit += kWarps - kFree) {  // the P carry",
     "unit < 0; unit += kWarps - kFree) {  // the P carry"),
)


#: the same for launch wkv6_bwd_states (in csrc/wkv6_bwd.cu too)
STATES_PHASES = (
    ("the running products", "for (int j = 0; j < kH; ++j) {  // the running products",
     "for (int j = 0; j < 0; ++j) {  // the running products"),
    ("the carry's products (tensor cores)",
     "for (int ks = 0; ks < kC / 8; ++ks) {  // the carry's products",
     "for (int ks = 0; ks < 0; ++ks) {  // the carry's products"),
)


def _nvcc(src: str, name: str) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *flags, "-o", str(so), str(cu)], check=True, capture_output=True)
    return so


def _events_ms(fn, iters: int = 1) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def probe_mma() -> None:
    lib = ctypes.CDLL(str(_nvcc(MMA_SOURCE, "mma_probe")))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(128, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    iters, blocks = 4096, 2 * sms
    for kind, name, flop in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8), (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for ch in (1, 8):
            ms = _events_ms(lambda: lib.run(kind, ch, blocks, iters, out.data_ptr(),
                                            cycles.data_ptr()), 3)
            n = blocks * 4 * ch * iters
            print(f"mma.sync {name}, {ch} chain(s) per warp, 8 warps per SM: "
                  f"{int(cycles) / (iters * ch):.1f} cycles per product per warp, "
                  f"{n * flop / ms / 1e9:.1f} TFLOP/s")


def _variants(source: str, phases: tuple, tag: str, count: int = 1) -> dict[str, Path]:
    """The source whole, with each phase cut in turn and with all of them
    cut, each built (in parallel); ``count`` copies of a phase's line are
    cut (-1: all)."""
    base = (CSRC / source).read_text()
    variants = {"whole": base}
    loads_only = base
    for name, line, cut in phases:
        if line not in base:
            raise RuntimeError(f"phase {name!r}: its line is no longer in {source}")
        variants[f"without {name}"] = base.replace(line, cut, count)
        loads_only = loads_only.replace(line, cut, count)
    variants["the loads and barriers alone"] = loads_only
    with ThreadPoolExecutor(len(variants)) as ex:
        return dict(zip(variants, ex.map(lambda kv: _nvcc(kv[1], f"{tag}_v{kv[0]}"),
                                         enumerate(variants.values()))))


def probe_phases() -> None:
    libs = _variants("wkv6.cu", PHASES, "wkv6")
    B, S, H, hd = 8, 1024, 32, 80
    gen = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, hd), generator=gen, device="cuda")) * 0.5 + 0.4
    u = torch.randn((H, hd), device="cuda") * 0.1
    s0 = torch.randn((B, H, hd, hd), device="cuda") * 0.1
    y, sT = torch.empty_like(w), torch.empty_like(s0)
    stream = torch.cuda.current_stream().cuda_stream
    args = [t.data_ptr() for t in (r, k, v, w, u, s0, y, sT)] + [B, S, H, hd, 1, 1, stream]
    times = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).wkv6_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        times[name] = _events_ms(lambda: fn(*args), 20)
    for name, ms in times.items():
        gap = "" if name == "whole" else f" ({times['whole'] - ms:+.4f} ms)"
        print(f"wkv6 chunked at {(B, S, H, hd)} bf16, {name}: {ms:.4f} ms{gap}")


def probe_bwd() -> None:
    from repro_torch.kernels import ops

    libs = _variants("wkv6_bwd.cu", BWD_PHASES, "wkv6_bwd", count=-1)
    states_libs = _variants("wkv6_bwd.cu", STATES_PHASES, "wkv6_bwd_states", count=-1)
    B, S, H, hd = 2, 1024, 32, 80
    gen = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, hd), generator=gen, device="cuda")) * 0.5 + 0.4
    u = torch.randn((H, hd), device="cuda") * 0.1
    s0 = torch.randn((B, H, hd, hd), device="cuda") * 0.1
    dy = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    P, G, _ = ops.wkv6_bwd_states(r, k, v, w, s0, dy)
    outs = [torch.empty_like(w) for _ in range(4)] + [torch.empty((B, H, P.shape[2], hd),
                                                                  device="cuda")]
    stream = torch.cuda.current_stream().cuda_stream
    args = ([t.data_ptr() for t in (r, k, v, w, u, dy, P, G, *outs)]
            + [B, S, H, hd, 1, ops.WKV6_BWD_CHUNK, stream])
    P2, G2, ds0 = torch.empty_like(P), torch.empty_like(G), torch.empty_like(s0)
    st_args = ([t.data_ptr() for t in (r, k, v, w, s0, dy)] + [None]
               + [t.data_ptr() for t in (P2, G2, ds0)]
               + [B, S, H, hd, 1, ops.WKV6_BWD_CHUNK, stream])
    st_times = {}
    for name, so in states_libs.items():
        fn = ctypes.CDLL(str(so)).wkv6_bwd_states_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        st_times[name] = min(_events_ms(lambda: fn(*st_args), 20) for _ in range(2))
    for name, ms in st_times.items():
        gap = "" if name == "whole" else f" ({st_times['whole'] - ms:+.4f} ms)"
        print(f"wkv6_bwd_states at {(B, S, H, hd)} bf16, {name}: {ms:.4f} ms{gap}")
    times = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).wkv6_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        times[name] = min(_events_ms(lambda: fn(*args), 20) for _ in range(2))
    for name, ms in times.items():
        gap = "" if name == "whole" else f" ({times['whole'] - ms:+.4f} ms)"
        print(f"wkv6_bwd at {(B, S, H, hd)} bf16, {name}: {ms:.4f} ms{gap}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*", metavar="{mma,phases,bwd}", help="default: all")
    probes = ap.parse_args().probes or ["mma", "phases", "bwd"]
    if set(probes) - {"mma", "phases", "bwd"}:
        ap.error(f"unknown probe in {probes}")
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA card")
    for name in probes:
        {"mma": probe_mma, "phases": probe_phases, "bwd": probe_bwd}[name]()


if __name__ == "__main__":
    main()
