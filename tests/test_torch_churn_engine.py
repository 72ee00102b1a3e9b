"""The convergence engine's churn and rejoin program
(``repro_torch.core.simulate``) against the JAX package's, and the harness
of test_torch_integrity_engine.py and test_torch_integrity.py's engine
cells.

The reference's key chain is replayed through the engine's ``draws`` hook
(:func:`reference_draws`): per step ``key, k1, k2 = split(key, 3)``, the
gradient and compressor draws from k1 and k2, then the churn mask's
uniforms ``uniform(fold_in(key, 0x6368), (n,))`` and the corruption's
``uniform(fold_in(key, CORRUPT_FOLD), (n,))`` from the new carry key.
Tolerances are the reference's: loss and consensus rtol 2e-4 / atol 1e-5,
bits rtol 1e-6, x* error 1e-3; the quarantine tallies exact.

* Every sync scheme x {``qsgd`` 16 EF, ``qsgd_kernel`` 16 EF} under 30%
  dropout in the window [2, 10), with ``reset`` and ``pull_avg``.
* A dropout-0 churn cell against its churn-free twin (rtol 1e-5 / atol
  1e-6; bitwise on the CPU), with the port's own draws.
* Dropout rates, vectors and windows share one class program; the rejoin
  policy splits it.
* The training substrate of ``run_scenarios`` and run.py's ``main`` carry
  the integrity tallies under the reference's keys.
"""

import json
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.core import simulate as J
from repro.core.compression import get_compressor as jget
from repro.experiments import run as jrun
from repro.experiments import runner as jrunner
from repro_torch.core import integrity
from repro_torch.core import simulate as P
from repro_torch.core.compression import get_compressor as pget
from repro_torch.experiments import run as prun
from repro_torch.experiments import runner as prunner
from repro_torch.experiments.scenario import Scenario
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

SCHEMES = ("bsp", "local", "ssp", "asp", "gossip")
COMPS = (("qsgd", {"levels": 16}), ("qsgd_kernel", {"levels": 16}))


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _chain(seed, steps, n, dim, noise_len):
    def step(key, _):
        key, k1, k2 = jax.random.split(key, 3)
        g = jax.vmap(lambda k: jax.random.normal(k, (dim,)))(jax.random.split(k1, n))
        u = jax.vmap(lambda k: jax.random.uniform(k, (max(noise_len, 1),)))(
            jax.random.split(k2, n))
        um = jax.random.uniform(jax.random.fold_in(key, integrity.MASK_FOLD), (n,))
        uc = jax.random.uniform(jax.random.fold_in(key, integrity.CORRUPT_FOLD), (n,))
        return key, (g, u, um, uc)

    return jax.lax.scan(step, jax.random.key(seed), None, length=steps)[1]


def reference_draws(seeds, steps, n, dim, noise_len, device, churn=False):
    """A ``draws`` factory replaying the reference engine's draws for the
    (C, R) seeds, the two churn uniforms too when ``churn``."""
    outs = [[], [], [], []]
    for row in seeds:
        chains = [_chain(int(sd), steps, n, dim, noise_len) for sd in row]
        for j in range(4):
            outs[j].append(np.stack([np.asarray(ch[j]) for ch in chains], 1))
    z, u, um, uc = (torch.from_numpy(np.stack(o, 1)).to(device) for o in outs)
    if churn:
        return lambda t: (z[t], u[t] if noise_len else None, um[t], uc[t])
    return lambda t: (z[t], u[t] if noise_len else None)


def cfg(mod, sync, name, kw, **over):
    """The reference test's churn cell (tests/test_churn.py::_cell) with
    ``name`` as compressor, in the package ``mod`` (J or P)."""
    get = jget if mod is J else pget
    base = dict(n_workers=4, sync=sync, steps=12, lr=0.03, staleness=2, local_steps=4,
                compressor=get(name, **kw), error_feedback=True, seed=7)
    base.update(over)
    return mod.SimCfg(**base)


EXTRAS = ("quarantined_bits", "quarantine_rounds", "escalations")


def engine_matches_reference(sync, name, kw, **over):
    want = J.simulate_training_batch(cfg(J, sync, name, kw, **over))[0]
    got = P.simulate_training_batch(cfg(P, sync, name, kw, **over), device="cpu",
                                    draws=reference_draws)[0]
    tag = f"{sync}/{name}/{over}"
    for k in ("loss", "consensus"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5, err_msg=f"{tag}/{k}")
    np.testing.assert_allclose(got["bits"], want["bits"], rtol=1e-6, err_msg=f"{tag}/bits")
    assert abs(got["x_star_err"] - want["x_star_err"]) < 1e-3, tag
    assert {k for k in EXTRAS if k in got} == {k for k in EXTRAS if k in want}, tag
    for k in EXTRAS:
        if k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float64),
                                          err_msg=f"{tag}/{k}")
    return got


WINDOW = dict(dropout_rate=0.3, churn_start=2, churn_end=10)
CELLS = [(sync, name, kw, policy) for sync in SCHEMES for name, kw in COMPS
         for policy in ("reset", "pull_avg")]


@pytest.mark.parametrize("sync,name,kw,policy", CELLS,
                         ids=[f"{s}-{n}-{p}" for s, n, _, p in CELLS])
def test_churn_engine_matches_reference(sync, name, kw, policy):
    engine_matches_reference(sync, name, kw, **WINDOW, rejoin_policy=policy)


@pytest.mark.parametrize("sync", SCHEMES)
def test_dropout0_churn_cell_is_its_churn_free_twin(sync):
    """The port's own draws: the churn uniforms come from a generator of
    their own, so the gradient and compressor noise is the twin's."""
    plain = P.simulate_training(cfg(P, sync, "qsgd_kernel", {"levels": 16}), device="cpu")
    churn0 = P.simulate_training(cfg(P, sync, "qsgd_kernel", {"levels": 16}, churn=True),
                                 device="cpu")
    for k in ("loss", "consensus", "bits"):
        np.testing.assert_allclose(churn0[k], plain[k], rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(churn0[k], plain[k], err_msg=k)


def test_dropout_values_share_one_class_program():
    """Rates, per-worker vectors and windows are values (one program); the
    rejoin policy is structural."""
    base = dict(n_workers=4, sync="local", steps=8, lr=0.03, local_steps=2, seed=1,
                compressor=pget("qsgd", levels=16), error_feedback=True, churn=True)
    cells = [P.SimCfg(**base, dropout_rate=r) for r in (0.0, 0.1, 0.3)]
    cells.append(P.SimCfg(**base, worker_dropout=(0.5, 0.0, 0.2, 0.0), churn_start=2,
                          churn_end=6))
    problem = P.quadratic_problem(n_workers=4, seed=1)
    P.engine_cache_clear()
    out = P.simulate_training_classbatch(cells, problem, device="cpu")
    assert P.engine_cache_stats().compiles == 1
    assert all(np.isfinite(c[0]["loss"]).all() for c in out)
    P.simulate_training_batch(P.SimCfg(**base, dropout_rate=0.1, rejoin_policy="pull_avg"),
                              problem, device="cpu")
    assert P.engine_cache_stats().compiles == 2
    # the classes' keys are the reference's
    jbase = dict(base, compressor=jget("qsgd", levels=16))
    for c in cells + [P.SimCfg(**base, rejoin_policy="pull_avg", dropout_rate=0.1)]:
        jc = J.SimCfg(**{**jbase, **{k: getattr(c, k) for k in
                                     ("dropout_rate", "worker_dropout", "churn_start",
                                      "churn_end", "rejoin_policy")}})
        assert P.shape_class_key(c)[5:] == J.shape_class_key(jc)[5:]


def test_pull_avg_charges_the_download():
    base = dict(sync="local", steps=40, dropout_rate=0.3, churn_start=5, churn_end=30)
    reset = P.simulate_training(cfg(P, **base, name="qsgd", kw={"levels": 16}), device="cpu")
    pull = P.simulate_training(cfg(P, **base, name="qsgd", kw={"levels": 16},
                                   rejoin_policy="pull_avg"), device="cpu")
    assert pull["bits"][-1] > reset["bits"][-1]
    assert np.isfinite(pull["loss"]).all() and pull["loss"][-1] < pull["loss"][0]


def test_runner_books_the_integrity_tallies():
    """The training substrate's measured row carries the reference's keys
    (quarantine_rounds, quarantined_gbits, escalations), equal to the
    reference's run on the same cell (grad noise 0, deterministic qsgd_kernel
    levels draw aside, both runs hold the tallies exactly via the replayed
    draws)."""
    s = Scenario(sync="bsp", n_workers=4, steps=12, lr=0.03, compressor="qsgd_kernel",
                 compressor_kwargs={"levels": 16}, error_feedback=True, corruption_rate=0.3,
                 corruption_kind="nan", quarantine_limit=2, seed=7)
    from repro.experiments import Scenario as JScenario

    js = JScenario(**{f: getattr(s, f) for f in ("sync", "n_workers", "steps", "lr",
                                                  "compressor", "compressor_kwargs",
                                                  "error_feedback", "corruption_rate",
                                                  "corruption_kind", "quarantine_limit",
                                                  "seed")})
    want = jrunner.run_scenarios([js], "training")[0].measured
    got = prunner.run_scenarios([s], "training", device="cpu", draws=reference_draws)[0].measured
    for k in ("quarantine_rounds", "quarantined_gbits", "escalations"):
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=2e-4, atol=1e-5)


def test_main_emits_churn_cells(tmp_path):
    """run.py's training grid with churn and corruption axes: the same cells
    and tags as the reference's, the tallies in the emitted record."""
    argv = ["--substrate", "training", "--workers", "4", "--steps", "10", "--grid",
            "sync=bsp,local compressor=qsgd:levels=16 dropout_rate=0.0,0.2 "
            "corruption_rate=0.1 corruption_kind=nan", "--no-speedup"]
    out = {}
    for mod, tag, extra in ((jrun, "ref", []), (prun, "port", ["--device", "cpu"])):
        path = tmp_path / f"{tag}.json"
        assert mod.main(argv + ["--emit-json", str(path)] + extra) == 0
        out[tag] = json.loads(path.read_text())
    assert [c["tag"] for c in out["port"]["cells"]] == [c["tag"] for c in out["ref"]["cells"]]
    for c in out["port"]["cells"]:
        for k in ("quarantine_rounds", "quarantined_gbits", "escalations"):
            assert k in c["measured"], (c["tag"], k)
