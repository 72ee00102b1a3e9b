"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``.  Builds
happen at first use, never at import: one ``nvcc`` per source, all started
together.  Libraries land in ``kernels/_build/`` (git-ignored) under a name
that hashes the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  With a persistent cache configured
(:mod:`repro_torch.core.compilecache`, read at the first build) they land
in ``<cache>/repro-kernels/`` instead, and the name also hashes the ``nvcc
--version`` release line and the card's name and compute capability, so a
later process on the same toolchain and card reuses every library and one
on another never does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: where the libraries go when no persistent cache is configured
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# --fmad=false keeps every multiply and add separately rounded, as in the
# plain PyTorch versions; no fast-math flag, so divisions stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_P, _F, _LL, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong, ctypes.c_int

#: C entry point and its argument types, per kernel source.  Every pointer
#: and the stream are c_void_p: a bare int would be cut to 32 bits.
SIGNATURES: dict[str, tuple[str, tuple]] = {
    "qsgd": ("qsgd_launch", (_P, _P, _P, _F, _P, _LL, _P)),
    "qsgd_ef": ("qsgd_ef_launch", (_P, _P, _P, _P, _F, _F, _P, _P, _LL, _P)),
    "int8_acc": ("int8_acc_launch", (_P, _LL, _P, _I, _P, _LL, _P)),
    "sign_pack": ("sign_pack_launch", (_P, _LL, _P, _LL, _P)),
    "sign_unpack": ("sign_unpack_launch", (_P, _P, _LL, _P)),
    "sign_vote": ("sign_vote_launch", (_P, _LL, _P, _I, _P, _LL, _P)),
    "terngrad": ("terngrad_launch", (_P, _P, _P, _P, _LL, _P)),
    "tern_pack": ("tern_pack_launch", (_P, _LL, _P, _LL, _P)),
    "tern_acc": ("tern_acc_launch", (_P, _LL, _P, _I, _P, _LL, _P)),
    "threshold": ("threshold_launch", (_P, _P, _P, _P, _LL, _P)),
    "wkv6": ("wkv6_launch", (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
}
#: the row-batched entry points (a (rows, n) stack with per-row scalars in
#: device memory), beside the flat ones in the same sources
ROW_SIGNATURES: dict[str, tuple[str, tuple]] = {
    "qsgd": ("qsgd_rows_launch", (_P, _P, _P, _P, _P, _LL, _LL, _P)),
    "qsgd_ef": ("qsgd_ef_rows_launch", (_P, _P, _P, _P, _P, _F, _P, _P, _LL, _LL, _P)),
    "terngrad": ("terngrad_rows_launch", (_P, _P, _P, _P, _LL, _LL, _P)),
}


@dataclass
class BuildRecord:
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    ptxas: str  # the compiler's -Xptxas -v report (registers, spills)


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def toolchain_fingerprint() -> str:
    """The ``nvcc --version`` release line and the card's name and compute
    capability: what a cached library is valid for besides its source."""
    import torch

    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                             check=True).stdout
        release = [ln for ln in out.splitlines() if "release" in ln][-1].strip()
    except (OSError, subprocess.CalledProcessError, IndexError):
        release = "nvcc not found"
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        card = f"{torch.cuda.get_device_name(0)} sm_{major}{minor}"
    else:
        card = "no card"
    return f"{release}; {card}"


class KernelLibrary:
    """Builds the kernel libraries on demand and hands out their C entry
    points.  One instance per process is enough; ``LIBRARY`` is it.  Each
    build asks :mod:`repro_torch.core.compilecache` for the persistent
    cache's ``repro-kernels/`` and falls back to :data:`BUILD_DIR`."""

    def __init__(self):
        self.records: dict[str, BuildRecord] = {}
        self._fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
        self._lock = threading.Lock()
        self._toolchain: str | None = None

    def _target(self, name: str) -> Path:
        from repro_torch.core import compilecache

        cached = compilecache.kernels_dir()
        key = (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
        if cached is not None:
            if self._toolchain is None:
                self._toolchain = toolchain_fingerprint()
            key += self._toolchain.encode()
        build_dir = BUILD_DIR if cached is None else cached
        return build_dir / f"lib{name}-{hashlib.sha1(key).hexdigest()[:12]}.so"

    def nvcc_builds(self) -> int:
        """Libraries this process compiled (the rest were reused)."""
        return sum(1 for r in self.records.values() if r.seconds > 0)

    def build(self, names=tuple(SIGNATURES)) -> dict[str, BuildRecord]:
        """Compile every named source not built yet, all in parallel; raise
        if any compile fails."""
        with self._lock:
            todo = [n for n in names if n not in self.records]
            if not todo:
                return self.records
            nvcc = _nvcc()
            procs = {}
            t0 = time.perf_counter()
            for name in todo:
                target = self._target(name)
                if target.exists():
                    self.records[name] = BuildRecord(target, 0.0, "")
                    continue
                if not os.path.exists(nvcc):
                    raise RuntimeError(f"nvcc not found; cannot build kernel {name!r}")
                target.parent.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True),
                               tmp, target)
            failed = []
            for name, (proc, tmp, target) in procs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
                    continue
                os.replace(tmp, target)
                self.records[name] = BuildRecord(target, time.perf_counter() - t0, out)
            if failed:
                raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
            return self.records

    def fn(self, name: str):
        """The C launch function of kernel ``name``, built and typed."""
        return self.symbol(name, *SIGNATURES[name])

    def symbol(self, name: str, symbol: str, argtypes: tuple):
        """The C function ``symbol`` (returning int) of kernel ``name``'s
        library, built and typed."""
        if (name, symbol) not in self._fns:
            rec = self.build((name,))[name]
            f = getattr(ctypes.CDLL(str(rec.path)), symbol)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            self._fns[(name, symbol)] = f
        return self._fns[(name, symbol)]


LIBRARY = KernelLibrary()
