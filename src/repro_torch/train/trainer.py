"""Training loop (counterpart of ``repro.train.trainer``, BSP branch):
feeds the data pipeline to the step bundle and logs metrics."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.transformer import init_params
from repro_torch.train.steps import StepBundle


@dataclass
class Trainer:
    bundle: StepBundle
    data: Any  # .batch(step) -> dict of global numpy arrays
    lr_fn: Callable[[int], float]
    log_every: int = 10
    history: list[dict] = field(default_factory=list)

    def _put(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.bundle.device)
                for k, v in batch.items()}

    def init(self, seed: int = 0) -> dict[str, Any]:
        b = self.bundle
        return b.init_state(init_params(b.cfg, seed, b.device))

    def fit(self, state: dict[str, Any], steps: int, start_step: int = 0) -> dict[str, Any]:
        b = self.bundle
        t0 = time.perf_counter()
        for t in range(start_step, start_step + steps):
            state, m = b.train_step(state, self._put(self.data.batch(t)), self.lr_fn(t))
            if self.log_every and (t % self.log_every == 0 or t == start_step + steps - 1):
                row = {k: float(v) for k, v in m.items()}
                row.update(step=t, wall=time.perf_counter() - t0)
                self.history.append(row)
        return state
