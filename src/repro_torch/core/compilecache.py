"""The port's persistent cache (counterpart of ``repro.core.compilecache``).

The port compiles no XLA program, so the directory holds what a cold
process of the port pays for instead:

* **the kernel libraries** (``<dir>/repro-kernels/``):
  :mod:`repro_torch.kernels.build` puts each ``nvcc`` build there, keyed by
  the source, the flags, the ``nvcc --version`` release line and the card's
  name and compute capability, so a later process on the same toolchain
  and card loads every library without compiling;
* **a manifest** (``<dir>/repro-torch-manifest/``) keyed by the port's own
  shape-class signatures: the engine's class key
  (``core/simulate.py``) and the trainer's bundle key (``BundleSpec`` and
  the rest of ``train/steps.py::bundle_cache_key``), salted with the torch,
  CUDA and device fingerprint and a hash of ``src/repro_torch/``'s sources.
  :func:`record_compile` is called when an in-memory registry misses and
  builds fresh: a signature already in the manifest is a persistent
  **hit**, otherwise a **miss**; ``engine_cache_stats()`` and
  ``bundle_cache_stats()`` carry the counts (``persistent_cache``).  An
  engine class program is Python construction with nothing to keep, so its
  entry is accounting only;
* **each bundle class's wire artifact** (``<dir>/repro-torch-wire/<digest>/
  wire.json``): the booked records of the meta-device ``_book_wire`` trace,
  so a warm process loads them and skips the trace (the reference's
  ``wire.json`` in ``repro-exec/``).

The reference's ``repro-manifest/`` and ``repro-exec/`` are never read or
written.  The directory comes from :func:`configure` (the ``--cache-dir``
flags) or the ``REPRO_TORCH_CACHE_DIR`` variable, read at first use; with
neither set every call is an uncounted no-op and the kernels build into
``kernels/_build/`` as before.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

ENV_VAR = "REPRO_TORCH_CACHE_DIR"
MANIFEST_DIRNAME = "repro-torch-manifest"
WIRE_DIRNAME = "repro-torch-wire"
KERNELS_DIRNAME = "repro-kernels"

_DIR: str | None = None
_ENV_CHECKED = False


@dataclass
class PersistentCacheStats:
    """Persistent hits and misses of one layer (``engine`` or ``bundle``):
    fresh in-memory builds whose signature was, or was not, already in the
    manifest.  In-memory hits never ask the disk."""

    hits: int = 0
    misses: int = 0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "dir": cache_dir()}


_STATS: dict[str, PersistentCacheStats] = {}


def stats(kind: str) -> PersistentCacheStats:
    return _STATS.setdefault(kind, PersistentCacheStats())


def reset_stats() -> None:
    _STATS.clear()


def cache_fingerprint(device=None) -> tuple:
    """torch and CUDA versions, the platform, the device's kind (name and
    compute capability on a card) and the card count: what a cache entry or
    a calibration profile is valid for.  ``device`` is where the work runs
    (default: the card when there is one, else the CPU).  The sources are
    hashed apart (:func:`source_fingerprint`), so a profile, which measures
    the machine, does not go stale with an edit."""
    import torch

    dev = torch.device(device if device is not None
                       else ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        idx = dev.index or 0
        major, minor = torch.cuda.get_device_capability(idx)
        kind, count = (f"{torch.cuda.get_device_name(idx)} sm_{major}{minor}",
                       torch.cuda.device_count())
    else:
        kind, count = "cpu", 1
    return (torch.__version__, torch.version.cuda, dev.type, kind, count)


_SOURCE_HASH: str | None = None
_PKG = Path(__file__).resolve().parents[1]


def source_fingerprint() -> str:
    """sha256 over the package's ``.py`` and ``.cu`` sources (relative path
    and contents, sorted), once per process: the shape-class keys name
    which build a cell needs, this pins what the build computes, so an edit
    invalidates every manifest entry and wire artifact."""
    global _SOURCE_HASH
    if _SOURCE_HASH is None:
        h = hashlib.sha256()
        for root, dirs, files in os.walk(_PKG):
            dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build"))
            for fn in sorted(files):
                if fn.endswith((".py", ".cu")):
                    path = os.path.join(root, fn)
                    h.update(os.path.relpath(path, _PKG).encode())
                    with open(path, "rb") as f:
                        h.update(f.read())
        _SOURCE_HASH = h.hexdigest()[:16]
    return _SOURCE_HASH


def stable_repr(key) -> str:
    """The serialization of a manifest key: ``repr`` of the key tuple, whose
    parts are primitives, tuples and frozen dataclasses of them."""
    return repr(key)


def stable_digest(kind: str, key) -> str:
    payload = repr((kind, cache_fingerprint(), source_fingerprint(), stable_repr(key)))
    return hashlib.sha256(payload.encode()).hexdigest()


def configure(path: str | None) -> str | None:
    """Use ``path`` as the persistent cache (``None`` detaches it).
    Returns the previous directory."""
    global _DIR, _ENV_CHECKED
    prev = _DIR
    _ENV_CHECKED = True
    if path is None:
        _DIR = None
        return prev
    path = os.path.abspath(path)
    os.makedirs(os.path.join(path, MANIFEST_DIRNAME), exist_ok=True)
    _DIR = path
    return prev


def cache_dir() -> str | None:
    """The configured directory; ``REPRO_TORCH_CACHE_DIR`` is read here, at
    first use, never at import."""
    global _ENV_CHECKED
    if not _ENV_CHECKED and _DIR is None:
        _ENV_CHECKED = True
        path = os.environ.get(ENV_VAR, "").strip()
        if path:
            configure(path)
    return _DIR


def kernels_dir() -> Path | None:
    """Where the kernel libraries go under the cache; None without one."""
    d = cache_dir()
    return None if d is None else Path(d) / KERNELS_DIRNAME


def wire_path(kind: str, key) -> str | None:
    """The wire artifact of one shape class; None without a cache."""
    d = cache_dir()
    if d is None:
        return None
    return os.path.join(d, WIRE_DIRNAME, stable_digest(kind, key), "wire.json")


def load_json(path: str | None):
    """The JSON at ``path``, or None when there is none."""
    if path is None:
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def save_json(path: str | None, obj) -> None:
    """Write ``obj`` to ``path`` atomically (concurrent writers race
    benignly); nothing when ``path`` is None."""
    if path is None:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def record_compile(kind: str, key) -> bool:
    """Called on a fresh in-memory build.  True iff the signature was in the
    manifest already (a persistent hit); False and uncounted without a
    cache."""
    d = cache_dir()
    if d is None:
        return False
    st = stats(kind)
    path = os.path.join(d, MANIFEST_DIRNAME, stable_digest(kind, key) + ".json")
    if os.path.exists(path):
        st.hits += 1
        return True
    st.misses += 1
    save_json(path, {"kind": kind, "key": stable_repr(key),
                     "fingerprint": list(cache_fingerprint()),
                     "source": source_fingerprint()})
    return False


def record(kind: str) -> dict:
    """The ``persistent_cache`` block of a ``--emit-json`` record."""
    return stats(kind).as_dict()
