"""Machine-fitted cost-model constants (counterpart of
``repro.core.calibrate``; Shi et al. arXiv:2005.13247, Wei et al.
arXiv:2403.07585: fit the alpha-beta model from measurements, not data
sheets).

The trainer lane's predictions (``experiments/trainer_substrate.py``)
default to data-sheet constants (``Link(alpha=1e-5, beta=1/50e9)``,
``Scenario.compute_time = 1.0`` s).  This module measures the device
instead:

* **collective rounds**: best-of-repeats of the port's stacked all-reduce
  (:func:`repro_torch.core.comms.psum` over W = 4 workers on one device)
  across the reference's ladder of payload sizes, least-squares fitted to
  ``t = alpha + beta * bytes``.  On one card the wire is booked, not moved,
  so this times an on-device reduction over the stacked axis; ``meta``
  says so;
* **launch overhead**: the median of a warm trivial launch ending in
  ``torch.cuda.synchronize()``, the fixed cost each message pays on top of
  the wire terms (``launch=`` of ``core/schedule.py``);
* **the dense step**: one measured dense-BSP run of the tiny trainer
  workload at W = 2 stacked (:func:`run_trainer_scenario`), the compute
  term of the trainer lane's step-time predictions.

``calibrate(trace_dir=...)`` records the measurements under
``torch.profiler``.  The fitted :class:`CalibrationProfile` persists as
JSON next to the persistent cache (``<cache>/calibration.json``,
:mod:`repro_torch.core.compilecache`) and reaches the predictions through
the active profile: ``set_active(profile)``; with none active every
prediction is the data sheet's.

    PYTHONPATH=src python -m repro_torch.core.calibrate [--out PATH] [--cache-dir DIR] \\
        [--trace-dir DIR] [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field

from repro_torch.core import compilecache
from repro_torch.core.costmodel import Link

DEFAULT_PROFILE_NAME = "calibration.json"
#: the reference's ladder of per-worker payload bytes
SIZES_BYTES = (1 << 12, 1 << 15, 1 << 18, 1 << 20, 1 << 22)
#: workers of the stacked all-reduce the ladder times
COLLECTIVE_WORKERS = 4


@dataclass
class CalibrationProfile:
    """Fitted cost-model constants and the measurements behind them."""

    alpha: float  # per-message latency (s), the fitted intercept
    beta: float  # seconds per payload byte, the fitted slope
    t_launch: float  # fixed cost of one warm launch (s)
    t_step_dense: float | None  # measured dense-BSP trainer step (s)
    meta: dict = field(default_factory=dict)

    def link(self) -> Link:
        return Link(alpha=self.alpha, beta=self.beta)

    def as_dict(self) -> dict:
        return {"alpha": self.alpha, "beta": self.beta, "t_launch": self.t_launch,
                "t_step_dense": self.t_step_dense, "meta": self.meta}

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationProfile":
        return cls(alpha=float(d["alpha"]), beta=float(d["beta"]),
                   t_launch=float(d["t_launch"]),
                   t_step_dense=(None if d.get("t_step_dense") is None
                                 else float(d["t_step_dense"])),
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.as_dict(), f, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# --- the active profile ------------------------------------------------------

_ACTIVE: CalibrationProfile | None = None


def set_active(profile: CalibrationProfile | None) -> CalibrationProfile | None:
    """Install ``profile`` for the process (None: the data-sheet constants
    again).  Returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, profile
    return prev


def get_active() -> CalibrationProfile | None:
    return _ACTIVE


def active_link(default: Link) -> Link:
    return _ACTIVE.link() if _ACTIVE is not None else default


def active_launch(default: float = 0.0) -> float:
    return _ACTIVE.t_launch if _ACTIVE is not None else default


def default_path() -> str | None:
    """Where the profile persists: next to the persistent cache."""
    d = compilecache.cache_dir()
    return os.path.join(d, DEFAULT_PROFILE_NAME) if d else None


def load_default(device=None) -> CalibrationProfile | None:
    """The profile saved next to the configured cache, if any.  One fitted
    under another :func:`compilecache.cache_fingerprint` (another torch or
    CUDA, another card, the CPU where ``device`` is the card or the other
    way round) is skipped with a note on stderr: ``run.py`` adopts this file
    by default, and another machine's constants would miscalibrate every
    predicted column.  Naming a file (``--calibration PATH``) is opting in
    and is not checked."""
    path = default_path()
    if not (path and os.path.exists(path)):
        return None
    profile = CalibrationProfile.load(path)
    stored = profile.meta.get("fingerprint")
    current = list(compilecache.cache_fingerprint(device))
    if stored is not None and list(stored) != current:
        print(f"# calibration: ignoring {path} (fitted on fingerprint {stored}, this "
              f"process is {current})", file=sys.stderr)
        return None
    return profile


# --- measurement -------------------------------------------------------------


def fit_alpha_beta(nbytes, times) -> tuple[float, float]:
    """Least-squares fit of ``t = alpha + beta * bytes``, clamped positive:
    a negative latency or bandwidth term is noise, not physics."""
    import numpy as np

    x = np.asarray(nbytes, dtype=float)
    y = np.asarray(times, dtype=float)
    if x.size < 2:
        raise ValueError("need >= 2 (bytes, time) points to fit alpha-beta")
    beta, alpha = np.polyfit(x, y, 1)
    return float(max(alpha, 1e-9)), float(max(beta, 1e-15))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_collective_times(sizes_bytes=SIZES_BYTES, repeats: int = 5, *,
                             workers: int = COLLECTIVE_WORKERS, device="cuda"
                             ) -> tuple[list[float], list[float]]:
    """Best-of-``repeats`` wall clock of one stacked all-reduce per payload
    size (per-worker f32 bytes) over ``workers`` rows on ``device``, each
    ending in a synchronize."""
    import torch

    from repro_torch.core import comms

    out_b, out_t = [], []
    for nbytes in sizes_bytes:
        elems = max(1, int(nbytes) // 4)
        x = torch.zeros((workers, elems), dtype=torch.float32, device=device)
        comms.psum(x)  # warm
        _sync(device)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            comms.psum(x)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        out_b.append(float(elems * 4))
        out_t.append(best)
    return out_b, out_t


def measure_launch_overhead(repeats: int = 20, *, device="cuda") -> float:
    """Median warm wall clock of a trivial launch (an add on 8 elements)
    ending in a synchronize: the fixed cost of host -> device and back."""
    import numpy as np
    import torch

    x = torch.zeros(8, dtype=torch.float32, device=device)
    x + 1.0
    _sync(device)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        x + 1.0
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_dense_step(*, steps: int = 6, device="cuda") -> float:
    """Measured per-step wall clock of the dense-BSP tiny trainer workload at
    W = 2 stacked (the first step excluded), with no profile active."""
    from repro_torch.experiments.scenario import Scenario
    from repro_torch.experiments.trainer_substrate import run_trainer_scenario

    s = Scenario(arch="allreduce", sync="bsp", compressor=None, steps=steps, n_workers=2,
                 lr=0.05)
    prev = set_active(None)  # the measurement must not read a stale profile
    try:
        res = run_trainer_scenario(s, data_par=2, device=device)
    finally:
        set_active(prev)
    return float(res.measured["step_time_s"])


def calibrate(out: str | None = None, *, steps: int = 6, repeats: int = 5,
              trace_dir: str | None = None, device="cuda") -> CalibrationProfile:
    """Measure ``device``, fit the constants, save them.

    ``out``: the profile's path (default ``<cache>/calibration.json`` when a
    persistent cache is configured, else not saved).  ``trace_dir``: record
    the measurements under ``torch.profiler`` and write its Chrome trace
    there (``calibrate_trace.json``)."""
    import torch

    prof = None
    if trace_dir is not None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        sizes, times = measure_collective_times(repeats=repeats, device=device)
        alpha, beta = fit_alpha_beta(sizes, times)
        t_launch = measure_launch_overhead(device=device)
        t_step = measure_dense_step(steps=steps, device=device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    trace = None
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        trace = os.path.join(trace_dir, "calibrate_trace.json")
        prof.export_chrome_trace(trace)
    profile = CalibrationProfile(
        alpha=alpha, beta=beta, t_launch=t_launch, t_step_dense=t_step,
        meta={
            "fingerprint": list(compilecache.cache_fingerprint(device)),
            "device": str(torch.device(device)),
            "sizes_bytes": sizes,
            "times_s": times,
            "collective": (f"comms.psum over {COLLECTIVE_WORKERS} workers stacked on one "
                           "device: an on-device reduction over the stacked axis (the "
                           "wire is booked, not moved)"),
            "dense_steps": steps,
            "trace": trace,
            "fitted_unix": time.time(),
        })
    path = out or default_path()
    if path:
        profile.save(path)
        profile.meta["path"] = path
    return profile


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.calibrate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="profile JSON path (default: <cache-dir>/calibration.json)")
    ap.add_argument("--cache-dir", default=os.environ.get(compilecache.ENV_VAR, ""),
                    help=f"the persistent cache (default ${compilecache.ENV_VAR})")
    ap.add_argument("--trace-dir", default=None,
                    help="record the measurements under torch.profiler and write the trace here")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="default cuda; cpu to run without a card")
    args = ap.parse_args(argv)
    if args.cache_dir:
        compilecache.configure(args.cache_dir)
    profile = calibrate(args.out or None, steps=args.steps, repeats=args.repeats,
                        trace_dir=args.trace_dir, device=args.device)
    print(json.dumps(profile.as_dict(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
