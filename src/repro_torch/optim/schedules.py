"""LR schedules (counterpart of ``repro.optim.schedules``), computed in f32
as the reference computes them; each returns a Python float per step."""

from __future__ import annotations

import numpy as np

f32 = np.float32


def constant(lr: float):
    return lambda step: float(f32(lr))


def warmup_cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def fn(step):
        s = f32(step)
        wu = min(s / f32(max(warmup, 1)), f32(1.0))
        prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)), f32(0.0), f32(1.0))
        cos = f32(final_frac) + f32(1 - final_frac) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
        return float(f32(lr) * wu * cos)

    return fn
