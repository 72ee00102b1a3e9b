"""The convergence engine's integrity program against the JAX package's
with test_torch_churn_engine.py's harness (the reference's draws replayed;
loss and consensus rtol 2e-4 / atol 1e-5, bits rtol 1e-6, the quarantine
tallies exact): the ``nan`` and ``inf`` kinds at 30% over every sync scheme
x {``qsgd`` EF, ``qsgd_kernel`` EF}, ``quarantine_limit`` 2 (``inf`` over a
20% dropout); and the bench's integrity claims at a
small size: every cell finite, quarantining, within 2x of its clean
twin's final loss.
"""

import numpy as np
import pytest

from repro_torch.core import simulate as P
from repro_torch.core.compression import get_compressor as pget
from test_torch_churn_engine import COMPS, SCHEMES, engine_matches_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

CELLS = [(sync, name, kw, kind) for sync in SCHEMES for name, kw in COMPS
         for kind in ("nan", "inf")]


@pytest.mark.parametrize("sync,name,kw,kind", CELLS,
                         ids=[f"{s}-{n}-{k}" for s, n, _, k in CELLS])
def test_integrity_engine_matches_reference(sync, name, kw, kind):
    over = dict(corruption_rate=0.3, corruption_kind=kind, quarantine_limit=2)
    if kind == "inf":
        over.update(dropout_rate=0.2)
    got = engine_matches_reference(sync, name, kw, **over)
    assert got["quarantine_rounds"][-1] > 0


@pytest.mark.parametrize("kind", ("nan", "inf", "spike", "bitflip"))
def test_corrupted_cells_stay_within_2x_of_clean(kind):
    problem = P.quadratic_problem(dim=24, n_workers=4, noise=0.1, seed=3)
    base = dict(sync="bsp", n_workers=4, steps=24, lr=0.03, compressor=pget("qsgd", levels=16),
                error_feedback=True, seed=7)
    hot = P.simulate_training_batch(P.SimCfg(**base, corruption_rate=0.1, corruption_kind=kind),
                                    problem, device="cpu")[0]
    clean = P.simulate_training_batch(P.SimCfg(**base, churn=True), problem, device="cpu")[0]
    assert np.isfinite(hot["loss"]).all()
    assert hot["loss"][-1] <= 2.0 * clean["loss"][-1]
    assert hot["quarantine_rounds"][-1] > 0
    assert hot["quarantined_bits"][-1] < hot["bits"][-1]
