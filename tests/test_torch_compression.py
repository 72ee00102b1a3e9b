"""The port's remaining compressors (``onebit``, ``qsgd``, ``natural``,
``natural_dithering`` in ``quantization.py``; ``size_adaptive`` and
``adaptive_qsgd`` in ``policy.py``; ``powersgd``; ``atomo_svd``) against
the JAX package's, on the same inputs and the reference's own uniform
draws (the lane of ``tests/test_compression.py``).

Tolerances, from the reference's properties (ROADMAP queue 3):

* codes are bitwise except where they sit on a rounding boundary that a
  sum in another order can move: the dither gap ``|y - floor(y) - u|`` (or
  ``|u - p|``) within 1e-5 where y depends on a norm (XLA sums in its own
  order), and ``|log2 y - round(log2 y)|`` within 1e-6 where a code floors
  or ceils a ``log2`` (XLA takes ``log(y) / log(2)``, which is not exact
  even at powers of two);
* norms, means and ``s`` within rtol 1e-6 (sums in another order);
* decoding the reference's own payload within rtol 1e-6 (XLA's ``exp2``
  is not exact below 2^-30);
* PowerSGD's decode within rtol 1e-5 (a QR and another matmul order), its
  Q up to the sign of each column; ATOMO's decoded reconstruction, not its
  factors (singular vectors are defined only up to sign), within rtol 1e-5
  and an atol of 1e-4 of its largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import get_compressor as jget_compressor
from repro.core.compression.base import _REGISTRY as JREGISTRY
from repro.core.compression.powersgd import shape2d as jshape2d
from repro_torch.core.compression import get_compressor
from repro_torch.core.compression.base import Compressed, list_compressors, noise_len
from repro_torch.core.compression.powersgd import shape2d
from repro_torch.core.types import CommConfig, validate
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

SIZES = [1000, 100_003]


def _x(n, seed):
    """0.1 * N(0, 1) with planted +0.0 and -0.0."""
    x = (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)
    x[::97] = 0.0
    x[3::89] = -0.0
    return x


def _both(name, n, p=None, **kw):
    """(port payload, reference payload, x, u, port compressor, reference
    compressor) of one compression; ``p``: runtime knob values
    (``compress_p``), else the baked ``compress``."""
    x = _x(n, n)
    comp, jcomp = get_compressor(name, **kw), jget_compressor(name, **kw)
    key = jax.random.key(n)
    u = np.array(jax.random.uniform(key, (noise_len(comp, n),)))
    if p is None:
        got = comp.compress(torch.from_numpy(u), torch.from_numpy(x.copy()))
        want = jcomp.compress(key, jnp.asarray(x))
    else:
        got = comp.compress_p(torch.from_numpy(u), torch.from_numpy(x.copy()), p)
        want = jcomp.compress_p(key, jnp.asarray(x), p)
    assert list(got.payload) == list(want.payload)
    for k, v in got.payload.items():
        w = np.asarray(want.payload[k])
        assert (v.numpy().dtype, tuple(v.shape)) == (w.dtype, w.shape), k
    return got, want, x, u, comp, jcomp


def _np(c, k):
    return c.payload[k].numpy()


def _decodes_reference_payload(comp, jcomp, want, p=None):
    """The port's decoder on the reference's own payload."""
    c = Compressed({k: torch.from_numpy(np.array(v)) for k, v in want.payload.items()}, want.n)
    got = comp.decompress(c) if p is None else comp.decompress_p(c, p)
    ref = jcomp.decompress(want) if p is None else jcomp.decompress_p(want, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


def test_registry_covers_the_reference_and_validates():
    """All 22 of the reference's compressor names are registered, and each
    validates on the dense wire."""
    assert list_compressors() == sorted(JREGISTRY) and len(JREGISTRY) == 22
    for name in list_compressors():
        validate(CommConfig(compressor=name))


@pytest.mark.parametrize("n", SIZES)
def test_onebit_matches_reference(n):
    got, want, x, _, comp, jcomp = _both("onebit", n)
    np.testing.assert_array_equal(_np(got, "bits"), np.asarray(want.payload["bits"]))
    np.testing.assert_allclose(_np(got, "mu"), np.asarray(want.payload["mu"]), rtol=1e-6)
    _decodes_reference_payload(comp, jcomp, want)


def _dither_keep(y, u, gap=1e-5):
    return np.abs(y - np.floor(y) - u) > gap


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("runtime", [False, True])
def test_qsgd_matches_reference(n, runtime):
    """The baked ``compress`` sends (code, norm), ``compress_p`` adds s."""
    p = {"levels": 16.0} if runtime else None
    got, want, x, u, comp, jcomp = _both("qsgd", n, p)
    norm = np.asarray(want.payload["norm"])
    np.testing.assert_allclose(_np(got, "norm"), norm, rtol=1e-6)
    if runtime:
        np.testing.assert_array_equal(_np(got, "s"), np.asarray(want.payload["s"]))
    keep = _dither_keep(np.abs(x.astype(np.float64)) / float(norm[0]) * 16, u)
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(_np(got, "code")[keep], np.asarray(want.payload["code"])[keep])
    _decodes_reference_payload(comp, jcomp, want, p)


def test_qsgd_levels_bound():
    for name in ("qsgd", "qsgd_kernel"):
        with pytest.raises(ValueError, match="int8"):
            get_compressor(name, levels=200).runtime_params()
    with pytest.raises(ValueError, match="int8"):
        get_compressor("qsgd", levels=128).batch_params(10)
    with pytest.raises(ValueError, match="var_target"):
        get_compressor("adaptive_qsgd", var_target=0.0).runtime_params()


def _log2_keep(y):
    """Where ``log2 y`` is more than 1e-6 from an integer."""
    lg = np.log2(np.maximum(y, 1e-300))
    return np.abs(lg - np.round(lg)) > 1e-6


@pytest.mark.parametrize("n", SIZES)
def test_natural_matches_reference(n):
    got, want, x, u, comp, jcomp = _both("natural", n)
    np.testing.assert_array_equal(_np(got, "sign"), np.asarray(want.payload["sign"]))
    keep = _log2_keep(np.abs(x.astype(np.float64)))
    np.testing.assert_array_equal(_np(got, "exp")[keep], np.asarray(want.payload["exp"])[keep])
    assert set(np.unique(_np(got, "exp")[x == 0])) == {-127}
    _decodes_reference_payload(comp, jcomp, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("runtime", [False, True])
def test_natural_dithering_matches_reference(n, runtime):
    """The baked ``compress`` sends (exp, sign, norm), ``compress_p`` adds L."""
    p = {"levels": 8.0} if runtime else None
    got, want, x, u, comp, jcomp = _both("natural_dithering", n, p)
    norm = np.asarray(want.payload["norm"])
    np.testing.assert_allclose(_np(got, "norm"), norm, rtol=1e-6)
    if runtime:
        np.testing.assert_array_equal(_np(got, "L"), np.asarray(want.payload["L"]))
    np.testing.assert_array_equal(_np(got, "sign"), np.asarray(want.payload["sign"]))
    y = np.abs(x.astype(np.float64)) / float(norm[0])
    ymin = 2.0 ** -7
    e = np.clip(np.ceil(np.log2(np.maximum(y, ymin))), -7, 0)
    hi = 2.0 ** e
    p_hi = np.where(y < ymin, y / ymin, (y - hi / 2) / (hi / 2))
    # below ymin both sides take log2(ymin) = -7 exactly
    keep = ((y < ymin) | _log2_keep(y)) & (np.abs(u - p_hi) > 1e-5)
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(_np(got, "exp")[keep], np.asarray(want.payload["exp"])[keep])
    _decodes_reference_payload(comp, jcomp, want, p)


@pytest.mark.parametrize("n", SIZES)
def test_size_adaptive_matches_reference(n):
    """The default threshold 65,536 sends 1,000 elements as f16 and 100,003
    as q8 codes with their scale, both bitwise (max|x| is exact in any
    order); 70,000 saturates to +-65504 in f16."""
    got, want, x, _, comp, jcomp = _both("size_adaptive", n)
    assert ("q8" in got.payload) == (n >= 65536)
    for k in got.payload:
        np.testing.assert_array_equal(_np(got, k), np.asarray(want.payload[k]))
    _decodes_reference_payload(comp, jcomp, want)
    big = torch.tensor([7e4, -7e4, 1.0])
    assert comp.compress(None, big).payload["half"].tolist() == [65504.0, -65504.0, 1.0]


@pytest.mark.parametrize("n", SIZES)
def test_adaptive_qsgd_matches_reference(n):
    """var_target 4 keeps s = ||x||_1 / (4 ||x||_2) inside (1, 127) at both
    sizes (about 6 and 63), so s is not a clip bound."""
    p = {"var_target": 4.0}
    got, want, x, u, comp, jcomp = _both("adaptive_qsgd", n, p, var_target=4.0)
    s, norm = np.asarray(want.payload["s"]), np.asarray(want.payload["norm"])
    np.testing.assert_allclose(_np(got, "s"), s, rtol=1e-6)
    np.testing.assert_allclose(_np(got, "norm"), norm, rtol=1e-6)
    assert 1.0 < float(s[0]) < 127.0
    keep = _dither_keep(np.abs(x.astype(np.float64)) / float(norm[0]) * float(s[0]), u)
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(_np(got, "code")[keep], np.asarray(want.payload["code"])[keep])
    _decodes_reference_payload(comp, jcomp, want, p)


@pytest.mark.parametrize("n", SIZES)
def test_powersgd_local_roundtrip_matches_reference(n):
    """Two local power iterations from the reference's initial Q (its
    ``key(7)`` draw, handed over as ``q0``)."""
    x = _x(n, n)
    comp, jcomp = get_compressor("powersgd"), jget_compressor("powersgd")
    assert shape2d(n) == jshape2d(n)
    q0 = np.array(jcomp.init_q(n, jax.random.key(7)))
    got = comp.compress(None, torch.from_numpy(x), q0=torch.from_numpy(q0))
    want = jcomp.compress(None, jnp.asarray(x))
    dec, jdec = comp.decompress(got).numpy(), np.asarray(jcomp.decompress(want))
    np.testing.assert_allclose(dec, jdec, rtol=1e-5, atol=1e-5 * np.abs(jdec).max())
    q, jq = _np(got, "Q"), np.asarray(want.payload["Q"])
    q = q * np.sign(np.sum(q * jq, axis=0))  # columns up to sign
    np.testing.assert_allclose(q, jq, rtol=1e-5, atol=1e-5 * np.abs(jq).max())
    assert comp.wire_bits(n) == jcomp.wire_bits(n)
    assert comp.init_q(n, 7).shape == q0.shape


@pytest.mark.parametrize("n", [1000, 28_672])
def test_atomo_decode_matches_reference(n):
    """1,000 elements as 25 x 40 and 28,672 (a qwen3 layer-norm stack) as
    128 x 224: one draw per singular value."""
    got, want, x, u, comp, jcomp = _both("atomo_svd", n)
    assert u.shape == (min(jcomp._shape2d(n)),)
    dec, jdec = comp.decompress(got).numpy(), np.asarray(jcomp.decompress(want))
    assert np.abs(jdec).max() > 0
    np.testing.assert_allclose(dec, jdec, rtol=1e-5, atol=1e-4 * np.abs(jdec).max())
    assert comp.wire_bits(n) == jcomp.wire_bits(n)


@pytest.mark.parametrize("name,kw", [
    ("onebit", {}), ("qsgd", {"levels": 16}), ("qsgd", {"levels": 4}), ("natural", {}),
    ("natural_dithering", {"levels": 8}), ("size_adaptive", {}),
    ("size_adaptive", {"threshold": 10}), ("adaptive_qsgd", {}), ("powersgd", {"rank": 2}),
    ("atomo_svd", {}),
])
def test_wire_bits_match_reference(name, kw):
    comp, jcomp = get_compressor(name, **kw), jget_compressor(name, **kw)
    for n in (12, 1000, 28_672, 65_536):
        assert comp.wire_bits(n) == jcomp.wire_bits(n), n
