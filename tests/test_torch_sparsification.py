"""The port's sparsifiers (repro_torch.core.compression.sparsification) and
``feedback.warmup_ratio`` against the JAX package's, on the same inputs and
the reference's own uniform draws.

Tolerances: the selections are exact: ``top_k`` returns ``lax.top_k``'s
index set in its order (ties to the lower index) on inputs rounded to bf16,
where magnitudes tie as they do in the trainer's widened bf16 gradients;
``topk``, ``gtopk``, ``randomk``, ``threshold`` and ``adaptive_threshold``
payloads are bitwise, ``quantile`` bitwise against ``jnp.quantile``, above
2**24 elements too.  Where a payload depends on a sum, the two sides sum in
other orders: ``sbc`` and ``stc`` values within rtol 1e-6; ``wangni``
(``sum|x|``) and ``variance_sparse`` (the population std) bitwise wherever
the draw or the magnitude is more than 1e-5 (relative) from its threshold,
and their kept counts within the number of elements closer than that.
``warmup_ratio`` within rtol 1e-6: its exponent is bitwise, and torch's
``exp`` and XLA's differ by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import get_compressor as jget_compressor
from repro.core.feedback import warmup_ratio as jwarmup_ratio
from repro_torch.core.compression import get_compressor
from repro_torch.core.compression.base import list_compressors
from repro_torch.core.compression.sparsification import quantile, top_k
from repro_torch.core.feedback import warmup_ratio
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

SIZES = [1000, 100_003]
SPARSIFIERS = ("topk", "gtopk", "randomk", "wangni", "threshold", "adaptive_threshold", "sbc",
               "stc", "variance_sparse")


def _x(n, seed, ties=False):
    """0.1 * N(0, 1) with planted +0.0 and -0.0; ``ties`` rounds it to bf16."""
    x = (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)
    x[::97] = 0.0
    x[3::89] = -0.0
    if ties:
        x = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    return x


def _both(name, n, seed, ties=False, **kw):
    """(port payload, reference payload, x, u) of one compression."""
    x = _x(n, seed, ties)
    key = jax.random.key(seed)
    u = np.array(jax.random.uniform(key, (n,)))
    got = get_compressor(name, **kw).compress(torch.from_numpy(u), torch.from_numpy(x.copy()))
    want = jget_compressor(name, **kw).compress(key, jnp.asarray(x))
    return got, want, x, u


def _np(c):
    return {k: v.numpy() for k, v in c.payload.items()}


def test_the_sparsifiers_are_registered():
    assert set(SPARSIFIERS) <= set(list_compressors())
    # ATOMO came with the low-rank slice; its parity is in test_torch_compression.py
    assert "atomo_svd" in list_compressors()
    for name in SPARSIFIERS + ("atomo_svd",):
        assert get_compressor(name).reduce_mode == jget_compressor(name).reduce_mode


@pytest.mark.parametrize("name", SPARSIFIERS)
@pytest.mark.parametrize("n", [1000, 100_003, 2**24 + 3])
def test_wire_bits_match_reference(name, n):
    got, want = get_compressor(name).wire_bits(n), jget_compressor(name).wire_bits(n)
    assert got == want or (got != got and want != want)  # NaN: data-dependent


@pytest.mark.parametrize("levels", [2, 16, 1000])
@pytest.mark.parametrize("n", SIZES)
def test_top_k_matches_lax_top_k_on_ties(n, levels):
    """Scores with only ``levels`` distinct values: the index set and its
    order equal ``lax.top_k``'s (descending, ties to the lower index)."""
    score = np.random.default_rng(levels).integers(0, levels, n).astype(np.float32) / levels
    for k in (1, 10, n // 100, n // 3, n):
        got = top_k(torch.from_numpy(score), k).numpy()
        want = np.asarray(jax.lax.top_k(jnp.asarray(score), k)[1])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name,kw", [("topk", {}), ("gtopk", {}), ("topk", {"k": 77}),
                                     ("randomk", {}), ("randomk", {"scale": False}),
                                     ("sbc", {}), ("stc", {"ratio": 0.05})])
def test_sparse_payloads_match_reference(name, kw, n, ties):
    got, want, x, _ = _both(name, n, 11, ties, **kw)
    g, w = _np(got), {k: np.asarray(v) for k, v in want.payload.items()}
    assert list(g) == list(w) == ["values", "indices"]
    assert g["indices"].dtype == w["indices"].dtype == np.int32
    np.testing.assert_array_equal(g["indices"], w["indices"])
    assert g["values"].dtype == w["values"].dtype == np.float32
    if name in ("sbc", "stc"):  # the shared magnitude is a sum in another order
        np.testing.assert_allclose(g["values"], w["values"], rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(g["values"].view(np.int32), w["values"].view(np.int32))
    dec = get_compressor(name, **kw).decompress(got).numpy()
    np.testing.assert_allclose(dec, np.asarray(jget_compressor(name, **kw).decompress(want)),
                               rtol=1e-6, atol=0)
    assert got.n == want.n == n


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("tau", [0.0, 0.05, 10.0])
def test_threshold_matches_reference(n, tau):
    """The masked values bitwise (a kept -0.0 stays -0.0; NaN is never kept,
    +-inf always) and the kept count exactly."""
    x = _x(n, 12)
    x[5::1001], x[7::1003], x[11::1009] = np.nan, np.inf, -np.inf
    got = get_compressor("threshold", tau=tau).compress(None, torch.from_numpy(x.copy()))
    want = jget_compressor("threshold", tau=tau).compress(jax.random.key(0), jnp.asarray(x))
    g, w = _np(got), {k: np.asarray(v) for k, v in want.payload.items()}
    np.testing.assert_array_equal(g["dense"].view(np.int32), w["dense"].view(np.int32))
    np.testing.assert_array_equal(g["nnz"], w["nnz"])
    assert g["nnz"].dtype == np.float32 and g["nnz"].shape == (1,)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("proportion", [0.01, 0.1, 0.5])
def test_adaptive_threshold_matches_reference(n, proportion, ties):
    got, want, x, _ = _both("adaptive_threshold", n, 13, ties, proportion=proportion)
    g, w = _np(got), {k: np.asarray(v) for k, v in want.payload.items()}
    np.testing.assert_array_equal(g["dense"].view(np.int32), w["dense"].view(np.int32))
    np.testing.assert_array_equal(g["nnz"], w["nnz"])


@pytest.mark.parametrize("n", [77, 1000, 4097, 100_003])
def test_quantile_matches_jnp_quantile(n):
    for seed in range(8):
        a = np.abs(np.random.default_rng(seed + n).standard_normal(n)).astype(np.float32)
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
            got = quantile(torch.from_numpy(a), q).numpy()
            want = np.asarray(jnp.quantile(jnp.asarray(a), q))
            assert got.tobytes() == want.tobytes(), (seed, q, got, want)
    a[n // 2] = np.nan
    assert np.isnan(quantile(torch.from_numpy(a), 0.5).numpy())
    assert np.isnan(np.asarray(jnp.quantile(jnp.asarray(a), 0.5)))


def test_quantile_position_is_f32_above_2_24():
    """n = 2**24 + 3: jax rounds n - 1 in f32 (to 2**24 + 4), so q = 0.99
    lands on another position than in exact arithmetic and q = 1.0 clamps
    to the last element; both bitwise against ``jnp.quantile``.  The input
    is in descending order, which both sides sort in a few seconds."""
    n = 2**24 + 3
    a = np.sort(np.random.default_rng(0).random(n, dtype=np.float32))[::-1].copy()
    qs = (0.99, 1.0)
    want = np.asarray(jnp.quantile(jnp.asarray(a), jnp.asarray(qs)))
    got = np.array([quantile(torch.from_numpy(a), q).item() for q in qs], np.float32)
    assert got.tobytes() == want.tobytes(), (got, want)
    exact = np.sort(a)[int(0.99 * (n - 1))]  # n - 1 in exact arithmetic
    assert want[0] != exact


@pytest.mark.parametrize("ratio", [0.01, 0.2])
@pytest.mark.parametrize("n", SIZES)
def test_wangni_matches_reference(n, ratio):
    got, want, x, u = _both("wangni", n, 14, ratio=ratio)
    g, w = _np(got), {k: np.asarray(v) for k, v in want.payload.items()}
    ax = np.abs(x.astype(np.float64))
    p = np.minimum(1.0, max(1.0, n * ratio) * ax / ax.sum())
    far = np.abs(u - p) > 1e-5 * np.maximum(p, 1e-30)
    assert far.mean() > 0.99
    np.testing.assert_allclose(g["dense"][far], w["dense"][far], rtol=1e-6, atol=0)
    assert abs(float(g["nnz"][0]) - float(w["nnz"][0])) <= (~far).sum()


@pytest.mark.parametrize("z", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("n", SIZES)
def test_variance_sparse_matches_reference(n, z):
    got, want, x, _ = _both("variance_sparse", n, 15, z=z)
    g, w = _np(got), {k: np.asarray(v) for k, v in want.payload.items()}
    bound = z * np.std(x.astype(np.float64))
    far = np.abs(np.abs(x) - bound) > 1e-5 * bound
    np.testing.assert_array_equal(g["dense"][far], w["dense"][far])
    assert abs(float(g["nnz"][0]) - float(w["nnz"][0])) <= (~far).sum()


@pytest.mark.parametrize("base,step,warmup", [
    (0.001, 0, 100), (0.001, 100, 100), (0.001, 50, 100),  # tests/test_feedback_sim.py
    (0.01, 0, 0), (0.01, 7, 0), (0.05, 3, 7), (0.1, 999, 1000), (0.01, 5000, 1000),
])
def test_warmup_ratio_matches_reference(base, step, warmup):
    got = warmup_ratio(base, step, warmup)
    want = np.asarray(jwarmup_ratio(base, jnp.asarray(step), warmup))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert float(warmup_ratio(0.001, 0, 100)) == pytest.approx(0.25)
    mid = float(warmup_ratio(0.001, torch.tensor(50), 100))
    assert 0.001 < mid < 0.25
