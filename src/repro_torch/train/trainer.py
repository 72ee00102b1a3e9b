"""Training loop (counterpart of ``repro.train.trainer``): drives the step
bundle by the CommConfig's sync scheme (under pod-local SGD the train step
every step and the sync step every H-th), feeds the data pipeline, logs
metrics and writes checkpoints."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.core import aggregate
from repro_torch.core import sync as sync_rules
from repro_torch.models.transformer import init_params
from repro_torch.train.steps import StepBundle


def wire_per_step(bundle: StepBundle, steps: int) -> float:
    """Booked wire bytes per step of a ``steps``-step run from step 0, each
    step's programs by the sync rules: ``grad_agg`` of a train step (every
    step under pod-local SGD; a pipelined one books its M rounds),
    ``local_sgd_sync`` of a sync step (every H-th), ``gossip_mix`` of a
    gossip step (the reference's ``trainer_wire_per_step``, counted step by
    step)."""
    comm, total = bundle.comm, 0.0
    for t in range(steps):
        if comm.aggregator == "gossip":
            total += bundle.wire["gossip"].get("gossip_mix", 0.0)
            continue
        if sync_rules.grads_need_aggregation(comm, t):
            total += bundle.wire["train"].get("grad_agg", 0.0)
        if sync_rules.params_need_sync(comm, t):
            total += bundle.wire["sync"].get("local_sgd_sync", 0.0)
    return total / steps


@dataclass
class Trainer:
    bundle: StepBundle
    data: Any  # .batch(step) -> dict of global numpy arrays
    lr_fn: Callable[[int], float]
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    log_every: int = 10
    history: list[dict] = field(default_factory=list)

    def _put(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.bundle.device)
                for k, v in batch.items()}

    def init(self, seed: int = 0) -> dict[str, Any]:
        b = self.bundle
        return b.init_state(init_params(b.cfg, seed, b.device, b.model))

    def save(self, path: str, state: dict[str, Any], step: int) -> None:
        """Checkpoint ``state`` at ``path`` in the reference's layout
        (``StepBundle.checkpoint_tree``), its manifest saying ``step``."""
        save(path, self.bundle.checkpoint_tree(state), step=step)

    def restore(self, path: str) -> tuple[dict[str, Any], int]:
        """The whole state of the checkpoint at ``path``; returns ``(state,
        step)``."""
        b = self.bundle
        tree, step = restore(path, b.checkpoint_like(), b.device)
        return b.from_checkpoint(tree), step

    def restore_rejoin(self, path: str) -> tuple[dict[str, Any], int]:
        """Restore for a worker re-entering a run: parameters, optimizer
        state and the step counter from the checkpoint at ``path``
        (``partial=True``: its comm state is stale by construction), and
        the communication state initialised fresh (zero EF residuals,
        momentum and CHOCO mirrors, PowerSGD's initial Q) with its step set
        to the restored one.  Returns ``(state, step)`` for
        ``fit(state, steps, start_step=step)``."""
        b = self.bundle
        tree, step = restore(path, b.checkpoint_like(("params", "opt", "step")), b.device,
                             partial=True)
        state = b.from_checkpoint(tree)
        state["comm"] = aggregate.init_comm_state(b.comm, b.bucket_plan, b.n_workers,
                                                  b.device, b.pods, b.model)
        state["comm"]["step"] = state["step"]
        return state, step

    def fit(self, state: dict[str, Any], steps: int, start_step: int = 0) -> dict[str, Any]:
        b, comm = self.bundle, self.bundle.comm
        t0 = time.perf_counter()
        for t in range(start_step, start_step + steps):
            batch, lr = self._put(self.data.batch(t)), self.lr_fn(t)
            if comm.aggregator == "gossip":
                state, m = b.gossip_step(state, batch, lr)
            elif sync_rules.grads_need_aggregation(comm, t):
                state, m = b.train_step(state, batch, lr)
            else:
                state, m = b.inner_step(state, batch, lr)
            if comm.aggregator != "gossip" and sync_rules.params_need_sync(comm, t):
                state = b.sync_step(state)
            if self.log_every and (t % self.log_every == 0 or t == start_step + steps - 1):
                row = {k: float(v) for k, v in m.items()}
                row.update(step=t, wall=time.perf_counter() - t0)
                self.history.append(row)
            if self.ckpt_dir and self.ckpt_every and (t + 1) % self.ckpt_every == 0:
                self.save(f"{self.ckpt_dir}/step{t + 1}", state, t + 1)
        return state
