"""The port's convergence engine against the JAX package's for the sync
schemes ssp, asp and gossip (the matrix of test_torch_simulate.py, the
same draws and tolerances), and its class batching: a class of mixed
knob values, learning rates and problem seeds equals each cell run alone,
builds one program, and a step's work does not grow with the batch."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import simulate as P
from repro_torch.core.compression import get_compressor as pget
from repro_torch.experiments.runner import run_scenarios, sweep_matrix_45
from test_torch_simulate import CELLS, engine_matches_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)


@pytest.mark.parametrize("sync", ("ssp", "asp", "gossip"))
@pytest.mark.parametrize("name,kw,ef", CELLS,
                         ids=[f"{n or 'dense'}-{'ef' if e else 'noef'}" for n, _, e in CELLS])
def test_engine_matches_reference(sync, name, kw, ef):
    engine_matches_reference(sync, name, kw, ef)


def _mixed_class():
    """One shape class (gossip, qsgd_kernel EF) of cells that differ in
    levels, lr, gossip weight and problem seed."""
    cfgs, probs = [], []
    for i, (lv, lr, seed) in enumerate(((2, 0.03, 0), (16, 0.05, 1), (8, 0.04, 1))):
        cfgs.append(P.SimCfg(n_workers=4, sync="gossip", steps=8, lr=lr, seed=seed,
                             gossip_w=0.2 + 0.05 * i, error_feedback=True,
                             compressor=pget("qsgd_kernel", levels=lv)))
        probs.append(P.quadratic_problem(n_workers=4, seed=seed))
    return cfgs, probs


def test_class_batch_equals_each_cell_alone():
    cfgs, probs = _mixed_class()
    P.engine_cache_clear()
    batch = P.simulate_training_classbatch(cfgs, problems=probs, seeds=[[5, 6]] * 3,
                                           device="cpu")
    assert P.engine_cache_stats().compiles == 1
    for c, prob, cell in zip(cfgs, probs, batch):
        alone = P.simulate_training_batch(c, prob, seeds=[5, 6], device="cpu")
        for got, want in zip(cell, alone):
            for k in ("loss", "consensus", "bits"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
    # the knobs bite: coarser levels send fewer bits, the cells differ
    assert batch[0][0]["bits"][-1] < batch[1][0]["bits"][-1]
    assert np.abs(batch[0][0]["loss"] - batch[1][0]["loss"]).max() > 1e-6


def test_class_batch_rejects_mixed_shape_classes():
    cfgs = [P.SimCfg(sync="bsp", n_workers=4, steps=4), P.SimCfg(sync="local", n_workers=4,
                                                                 steps=4)]
    with pytest.raises(ValueError, match="shape class"):
        P.simulate_training_classbatch(cfgs, P.quadratic_problem(n_workers=4), device="cpu")


def test_sweep_builds_one_program_per_shape_class():
    matrix = sweep_matrix_45(steps=4, n_workers=4)
    P.engine_cache_clear()
    run_scenarios(matrix, "training", device="cpu")
    assert P.engine_cache_stats().compiles == 5
    run_scenarios(matrix, "training", device="cpu")
    st = P.engine_cache_stats()
    assert st.compiles == 5 and st.hits == 5


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _fixed_draws(seeds, steps, n, dim, noise_len, device):
    """Draws made before the run, so that only the engine's own work counts."""
    C, R = len(seeds), len(seeds[0])
    z = torch.randn((steps, C, R, n, dim))
    u = torch.rand((steps, C, R, n, noise_len)) if noise_len else None
    return lambda t: (z[t], u[t] if u is not None else None)


def _ops_of_two_classes(n_cells: int, replicas: int) -> int:
    """Operations dispatched by a sweep of two shape classes (bsp with
    qsgd_kernel EF, gossip with terngrad_kernel) of ``n_cells`` cells each."""
    total = 0
    for sync, comp, ef in (("bsp", "qsgd_kernel", True), ("gossip", "terngrad_kernel", False)):
        cfgs = [P.SimCfg(n_workers=4, sync=sync, steps=6, lr=0.01 * (i + 1), seed=i,
                         compressor=pget(comp), error_feedback=ef) for i in range(n_cells)]
        prob = P.quadratic_problem(n_workers=4, seed=0)
        with _CountOps() as count:
            P.simulate_training_classbatch(cfgs, prob, seeds=[list(range(replicas))] * n_cells,
                                           device="cpu", draws=_fixed_draws)
        total += count.n
    return total


def test_step_work_does_not_grow_with_the_batch():
    """Cells, replicas and workers are tensor axes: a sweep of 2 classes
    dispatches as many operations (kernel launches on the card) at 2 cells x
    2 replicas as at 6 cells x 3 replicas."""
    assert _ops_of_two_classes(2, 2) == _ops_of_two_classes(6, 3)
