"""The port's convergence engine (repro_torch.core.simulate) against the JAX
package's on the same inputs.

Torch cannot replay jax's threefry draws, so the reference's key chain
(``key = jax.random.key(seed)``; per step ``key, k1, k2 = split(key, 3)``,
``gkeys = split(k1, n)``, ``ckeys = split(k2, n)``; ``normal(gkeys[i],
(dim,))`` and ``uniform(ckeys[i], (noise_len,))``) is fed to the port's
engine through its ``draws`` hook (:func:`reference_draws`).  Tolerances
are the reference's own: loss and consensus series rtol 2e-4 / atol 1e-5,
bits rtol 1e-6, x* error 1e-3 (tests/test_scan_engine.py,
test_sweep_batched.py).  This module runs the sync schemes bsp and local;
test_torch_simulate_schemes.py runs ssp, asp and gossip and the class
batching, test_torch_simulate_registry.py every registered compressor.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.core import simulate as J
from repro.core.compression import get_compressor as jget
from repro_torch.core import simulate as P
from repro_torch.core.compression import get_compressor as pget
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

#: the compressors of the engine matrix (the kernel-backed three, top-k and
#: the threshold among them), with the reference's test kwargs
COMPRESSORS = (
    (None, {}),
    ("qsgd_kernel", {"levels": 16}),
    ("terngrad_kernel", {}),
    ("signsgd_packed", {}),
    ("topk", {"ratio": 0.1}),
    ("threshold", {"tau": 0.5}),
)


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _chain(seed, steps, n, dim, noise_len):
    def step(key, _):
        key, k1, k2 = jax.random.split(key, 3)
        g = jax.vmap(lambda k: jax.random.normal(k, (dim,)))(jax.random.split(k1, n))
        u = jax.vmap(lambda k: jax.random.uniform(k, (max(noise_len, 1),)))(
            jax.random.split(k2, n))
        return key, (g, u)

    return jax.lax.scan(step, jax.random.key(seed), None, length=steps)[1]


def reference_draws(seeds, steps, n, dim, noise_len, device):
    """A ``draws`` factory replaying the reference engine's draws for the
    (C, R) seeds: the step hook returns (C, R, n, dim) normals and (C, R, n,
    noise_len) uniforms (None when noise_len is 0)."""
    z, u = [], []
    for row in seeds:
        chains = [_chain(int(sd), steps, n, dim, noise_len) for sd in row]
        z.append(np.stack([np.asarray(g) for g, _ in chains], 1))
        u.append(np.stack([np.asarray(v) for _, v in chains], 1))
    z = torch.from_numpy(np.stack(z, 1)).to(device)  # (steps, C, R, n, dim)
    u = torch.from_numpy(np.stack(u, 1)).to(device)
    return lambda t: (z[t], u[t] if noise_len else None)


def cfg(mod, sync, name, kw, ef, **over):
    """The reference test's cell (tests/test_scan_engine.py::_cfg) in the
    package ``mod`` (J or P)."""
    get = jget if mod is J else pget
    base = dict(n_workers=4, sync=sync, steps=10, lr=0.03, staleness=3, local_steps=4,
                compressor=get(name, **kw) if name else None, error_feedback=ef, seed=3)
    base.update(over)
    return mod.SimCfg(**base)


def assert_equivalent(got, want, tag=""):
    for k in ("loss", "consensus"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-5, err_msg=f"{tag}/{k}")
    np.testing.assert_allclose(got["bits"], want["bits"], rtol=1e-6, err_msg=f"{tag}/bits")
    assert abs(got["x_star_err"] - want["x_star_err"]) < 1e-3, tag


def engine_matches_reference(sync, name, kw, ef, **over):
    """One cell through both engines (the reference's simulate_training_batch,
    the port's with the reference's draws)."""
    want = J.simulate_training_batch(cfg(J, sync, name, kw, ef, **over))[0]
    got = P.simulate_training_batch(cfg(P, sync, name, kw, ef, **over), device="cpu",
                                    draws=reference_draws)[0]
    assert_equivalent(got, want, tag=f"{sync}/{name}/ef={ef}")
    return got


CELLS = [(name, kw, ef) for name, kw in COMPRESSORS for ef in (False, True)
         if not (ef and name is None)]


@pytest.mark.parametrize("sync", ("bsp", "local"))
@pytest.mark.parametrize("name,kw,ef", CELLS,
                         ids=[f"{n or 'dense'}-{'ef' if e else 'noef'}" for n, _, e in CELLS])
def test_engine_matches_reference(sync, name, kw, ef):
    engine_matches_reference(sync, name, kw, ef)


def test_engine_matches_its_loop_reference():
    """The port's batched engine and its per-step loop, the same draws."""
    for sync in ("bsp", "local", "ssp", "asp", "gossip"):
        c = cfg(P, sync, "qsgd", {"levels": 16}, True, steps=12)
        got = P.simulate_training(c, device="cpu")
        want = P.simulate_training_reference(c, device="cpu")
        assert_equivalent(got, want, tag=sync)


def test_problems_equal_the_reference_bitwise():
    for seed, n in ((0, 8), (3, 4)):
        jq, pq = J.quadratic_problem(n_workers=n, seed=seed), P.quadratic_problem(n_workers=n,
                                                                                 seed=seed)
        for k in ("A", "b", "x_star"):
            np.testing.assert_array_equal(pq.data[k].numpy(), np.asarray(jq.data[k]), err_msg=k)
        np.testing.assert_array_equal(pq[3].numpy(), np.asarray(jq[3]))
        assert pq.data_key == jq.data_key and pq.noise == jq.noise
        jl, pl = J.logistic_problem(n_workers=n, seed=seed), P.logistic_problem(n_workers=n,
                                                                               seed=seed)
        for k in ("feats", "labels", "x_star"):
            np.testing.assert_array_equal(pl.data[k].numpy(), np.asarray(jl.data[k]), err_msg=k)
        assert pl.data_key == jl.data_key


def test_logistic_cell_matches_reference():
    jp = J.logistic_problem(n_workers=4, seed=1)
    pp = P.logistic_problem(n_workers=4, seed=1)
    want = J.simulate_training_batch(cfg(J, "bsp", "qsgd", {"levels": 8}, True, lr=0.3),
                                     jp, seeds=[3, 4])
    got = P.simulate_training_batch(cfg(P, "bsp", "qsgd", {"levels": 8}, True, lr=0.3), pp,
                                    seeds=[3, 4], device="cpu", draws=reference_draws)
    for g, w in zip(got, want):
        assert_equivalent(g, w, tag="logistic")


@pytest.mark.parametrize("field,value", [("churn", True), ("dropout_rate", 0.1),
                                         ("worker_dropout", (0.1, 0.0, 0.0, 0.0)),
                                         ("rejoin_policy", "pull_avg"),
                                         ("corruption_rate", 0.05), ("corruption_kind", "nan")])
def test_churn_and_integrity_cells_are_refused(field, value):
    """The engine runs churn and integrity cells now
    (test_torch_churn_engine.py); what it refuses, as the reference's
    split_cfg does, is a churn or integrity value out of range, with a
    message naming the field, and the loop reference refuses every churn
    cell (it runs churn-free cells only, as the reference's)."""
    bad = {"churn": dict(worker_dropout=(0.1, 0.0)),
           "dropout_rate": dict(rejoin_policy="bogus"),
           "worker_dropout": dict(worker_dropout=(0.1, 0.0, 0.0)),
           "rejoin_policy": dict(rejoin_policy="pull"),
           "corruption_rate": dict(corruption_rate=1.0, corruption_kind="nan"),
           "corruption_kind": dict(corruption_kind="nans")}[field]
    c = cfg(P, "bsp", "qsgd", {"levels": 16}, True, **{field: value, **bad})
    match = "worker_dropout|rejoin_policy|corruption_rate|corruption_kind"
    with pytest.raises(ValueError, match=match):
        P.simulate_training(c, device="cpu")
    with pytest.raises(ValueError, match=match):
        P.split_cfg(c, dim=64)
    good = cfg(P, "bsp", "qsgd", {"levels": 16}, True, **{field: value})
    if field in ("churn", "dropout_rate", "worker_dropout", "corruption_rate"):
        with pytest.raises(ValueError, match=field):
            P.simulate_training_reference(good, device="cpu")


def test_unknown_sync_is_refused():
    with pytest.raises(ValueError, match="allreduce"):
        P.simulate_training(P.SimCfg(sync="allreduce", n_workers=4, steps=2), device="cpu")
