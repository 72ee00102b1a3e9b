"""The port's kernel layer (repro_torch.kernels) against the JAX package's
Pallas kernels, run in interpret mode on the CPU, and — on a CUDA card —
each hand-written kernel against its plain PyTorch version.

Tolerances: codes are bitwise equal where both sides see the same scalars
(the 2-D kernels); through the flat API the two norm reductions sum in
different orders, so codes are compared only where the dither draw is more
than 1e-5 away from its threshold.  The residual e' and int8_acc keep the
reference's own tolerances (tests/test_kernels.py, test_wire_formats.py).
The 1-bit sign wire is exact: packed bytes (pads included), unpacked
values and votes with 0/1 weights bitwise; votes with general weights
within rtol 1e-6 (the two sides may add the W terms in other orders).  The
2-bit ternary wire likewise: codes and smax bitwise through the flat API too
(``max|x|`` does not depend on the reduction order), packed bytes (pads
included) bitwise, accumulated sums bitwise with 0/1 weights and within
rtol 1e-6 with general ones.  The threshold kernel is exact: masked values
bitwise (int32 views) and kept counts equal, on inputs holding +-0.0, NaN
and +-inf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import qsgd as jqsgd
from repro.kernels import qsgd_ef as jqsgd_ef
from repro.kernels import sign_pack as jsign
from repro.kernels import terngrad as jtern
from repro.kernels import threshold_sparsify as jthr
from repro.kernels import wire_reduce as jwire
from repro_torch.core.compression.sparsification import top_k
from repro_torch.kernels import ops, ref
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

SIZES = [100, 1000, 32768, 100_003]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    return torch.device("cuda")


def _data(n, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    x[:: 97] = 0.0  # sign(0) = 0 must survive
    return x, rng.random(n, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _s(v):
    return torch.tensor(v, dtype=torch.float32)


# ---------------------------------------------------------------------------
# 2-D kernels: same inputs and scalars on both sides -> bitwise codes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [256, 512])
@pytest.mark.parametrize("levels", [4.0, 16.0, 127.0])
def test_qsgd_plain_matches_pallas_2d(rows, levels):
    x, u = _data(rows * 128, rows)
    inv = np.float32(1.0) / np.float32(np.linalg.norm(x))
    want = jqsgd.qsgd_2d(jnp.asarray(x.reshape(rows, 128)), jnp.asarray(u.reshape(rows, 128)),
                         jnp.full((1, 1), inv), jnp.full((1, 1), levels, jnp.float32),
                         interpret=True)
    got = torch.empty(x.size, dtype=torch.int8)
    ops.qsgd_codes_into(_t(x), _t(u), _s(inv), levels, got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1))


@pytest.mark.parametrize("decay", [1.0, 0.9])
@pytest.mark.parametrize("levels", [4.0, 16.0])
def test_qsgd_ef_plain_matches_pallas_2d(decay, levels):
    rows = 256
    g, u = _data(rows * 128, 7)
    e, _ = _data(rows * 128, 8, scale=0.05)
    inv = np.float32(1.0) / np.float32(np.linalg.norm(e * np.float32(decay) + g))
    sh = (rows, 128)
    want_c, want_e = jqsgd_ef.qsgd_ef_2d(
        jnp.asarray(g.reshape(sh)), jnp.asarray(e.reshape(sh)), jnp.asarray(u.reshape(sh)),
        jnp.full((1, 1), inv), jnp.full((1, 1), levels, jnp.float32),
        jnp.full((1, 1), decay, jnp.float32), interpret=True)
    codes = torch.empty(g.size, dtype=torch.int8)
    e_new = torch.empty(g.size)
    ops.qsgd_ef_into(_t(g), _t(e), _t(u), _s(inv), levels, decay, codes, e_new)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c).reshape(-1))
    np.testing.assert_allclose(e_new.numpy(), np.asarray(want_e).reshape(-1),
                               rtol=1e-6, atol=1e-7)


def test_qsgd_ef_in_place_residual():
    """e_out=e overwrites the residual with the same values as a fresh buffer."""
    g, u = _data(1000, 3)
    e, _ = _data(1000, 4, scale=0.05)
    c1, n1, e1 = ops.qsgd_ef_fused(_t(g), _t(e), _t(u), 16, 0.9)
    e_buf = _t(e.copy())
    c2, n2, e2 = ops.qsgd_ef_fused(_t(g), e_buf, _t(u), 16, 0.9, e_out=e_buf)
    assert e2.data_ptr() == e_buf.data_ptr()
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())
    np.testing.assert_array_equal(e1.numpy(), e_buf.numpy())


# ---------------------------------------------------------------------------
# Flat API against repro.kernels.ops.
# ---------------------------------------------------------------------------


def _far_from_threshold(a, u, norm, levels):
    y = np.abs(a.astype(np.float64)) / float(norm) * levels
    return np.abs(y - np.floor(y) - u) > 1e-5


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("levels", [4, 16, 64])
def test_qsgd_quantize_matches_reference(n, levels):
    x, u = _data(n, n + levels)
    want_c, want_n = jops.qsgd_quantize(jnp.asarray(x), jnp.asarray(u), levels=levels)
    got_c, got_n = ops.qsgd_quantize(_t(x), _t(u), levels)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-6)
    keep = _far_from_threshold(x, u, np.asarray(want_n)[0], levels)
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(got_c.numpy()[keep], np.asarray(want_c)[keep])
    # decode (a plain tensor op on both sides)
    np.testing.assert_allclose(
        ops.qsgd_dequantize(got_c, got_n, levels).numpy()[keep],
        np.asarray(jops.qsgd_dequantize(want_c, want_n, levels=levels))[keep], rtol=1e-6)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_qsgd_ef_fused_matches_reference(n, decay):
    g, u = _data(n, n)
    e, _ = _data(n, n + 1, scale=0.05)
    want_c, want_n, want_e = jops.qsgd_ef_fused(jnp.asarray(g), jnp.asarray(e), jnp.asarray(u),
                                                levels=16, decay=decay)
    got_c, got_n, got_e = ops.qsgd_ef_fused(_t(g), _t(e), _t(u), 16, decay)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-6)
    a = e * np.float32(decay) + g
    keep = _far_from_threshold(a, u, np.asarray(want_n)[0], 16)
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(got_c.numpy()[keep], np.asarray(want_c)[keep])
    np.testing.assert_allclose(got_e.numpy()[keep], np.asarray(want_e)[keep],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_w", [3, 4])
@pytest.mark.parametrize("n", [9000, 10_007])
def test_int8_weighted_sum_matches_reference(n_w, n):
    rng = np.random.default_rng(40 + n_w)
    codes = rng.integers(-127, 128, (n_w, n)).astype(np.int8)
    weights = np.linspace(0.01, 0.05, n_w).astype(np.float32)
    weights[1] = 0.0  # a masked-out worker
    want = jops.int8_weighted_sum(jnp.asarray(codes), jnp.asarray(weights))
    got = ops.int8_weighted_sum(_t(codes), _t(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_int8_weighted_sum_padded_rows():
    """A wire stack with padded rows (stride > n) reads only the n columns."""
    rng = np.random.default_rng(5)
    full = rng.integers(-127, 128, (3, 112)).astype(np.int8)
    w = np.asarray([0.5, 0.25, 2.0], np.float32)
    got = ops.int8_weighted_sum(_t(full)[:, :101], _t(w))
    want = (full[:, :101].astype(np.float32) * w[:, None]).sum(0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_cpu_tensors_take_the_plain_path():
    ops.reset_launches()
    x, u = _data(1000, 0)
    ops.qsgd_quantize(_t(x), _t(u), 16)
    ops.qsgd_ef_fused(_t(x), _t(x), _t(u), 16, 1.0)
    ops.int8_weighted_sum(torch.zeros((2, 10), dtype=torch.int8), torch.ones(2))
    packed = ops.sign_pack(_t(x))
    ops.sign_unpack(packed, 1000)
    ops.sign_vote(torch.stack([packed, packed]), torch.ones(2), 1000)
    tern, _ = ops.terngrad_quantize(_t(x), _t(u))
    tpacked = ops.tern_pack(tern)
    ops.tern_acc(torch.stack([tpacked, tpacked]), torch.ones(2), 1000)
    ops.threshold_sparsify(_t(x), 0.05)
    r = _t(x[:64]).view(1, 2, 2, 16)
    ops.wkv6(r, r, r, torch.full_like(r, 0.5), torch.zeros(2, 16), torch.zeros(1, 2, 16, 16))
    ops.wkv6_backward(r, r, r, torch.full_like(r, 0.5), torch.zeros(2, 16),
                      torch.zeros(1, 2, 16, 16), r)
    assert ops.LAUNCHES == {"qsgd": 0, "qsgd_ef": 0, "int8_acc": 0, "sign_pack": 0,
                            "sign_unpack": 0, "sign_vote": 0, "terngrad": 0,
                            "tern_pack": 0, "tern_acc": 0, "threshold": 0, "wkv6": 0,
                            "wkv6_bwd_states": 0, "wkv6_bwd": 0}


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(10)
    with pytest.raises(ValueError):
        ops.qsgd_codes_into(x, torch.zeros(9), torch.ones(()), 16, torch.empty(10, dtype=torch.int8))
    with pytest.raises(ValueError):
        ops.int8_weighted_sum(torch.zeros((2, 10), dtype=torch.int8), torch.ones(3))


def test_sign_wrappers_reject_bad_inputs():
    x = torch.zeros(2000)
    with pytest.raises(ValueError, match="packed"):  # one byte short of the padded payload
        ops.sign_pack(x, out=torch.empty(1023, dtype=torch.uint8))
    with pytest.raises(ValueError, match="on cpu"):  # output on another device
        ops.sign_pack(x, out=torch.empty(1024, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="packed"):  # 128 bytes cover 1024 elements only
        ops.sign_unpack(torch.zeros(128, dtype=torch.uint8), 1025)
    with pytest.raises(ValueError, match="packed"):
        ops.sign_vote(torch.zeros((2, 1024), dtype=torch.int8), torch.ones(2), 10)
    with pytest.raises(ValueError, match="weights"):
        ops.sign_vote(torch.zeros((2, 1024), dtype=torch.uint8), torch.ones(3), 10)


@pytest.mark.parametrize("bad", ["u", "inv", "inv_size", "e_out"])
def test_wrapper_rejects_tensors_off_the_launch_device(bad):
    """Every pointer a kernel would read must lie on the launch's device
    (``meta`` stands in for another device here); inv is one f32 element."""
    n = 10
    args = dict(g=torch.zeros(n), e=torch.zeros(n), u=torch.zeros(n), inv=torch.ones(()),
                codes=torch.empty(n, dtype=torch.int8), e_out=torch.empty(n))
    if bad == "inv_size":
        args["inv"] = torch.ones(2)
    else:
        args[bad] = args[bad].to("meta")
    with pytest.raises(ValueError, match="inv" if bad == "inv_size" else bad):
        ops.qsgd_ef_into(args["g"], args["e"], args["u"], args["inv"], 16.0, 1.0,
                         args["codes"], args["e_out"])
    if bad in ("u", "inv", "inv_size"):
        with pytest.raises(ValueError):
            ops.qsgd_codes_into(args["g"], args["u"], args["inv"], 16.0, args["codes"])


# ---------------------------------------------------------------------------
# The 1-bit sign wire: plain versions against the Pallas kernels and the
# reference's flat API.
# ---------------------------------------------------------------------------


def _signs(n, seed):
    """Normal draws with +0.0, -0.0 and NaN planted (x >= 0: 1, 1, 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[::7] = 0.0
    x[3::11] = -0.0
    x[5::101] = np.nan
    return x


def _votes_data(n, n_w, seed):
    """W packed rows with 2-2 ties at W = 4: rows 2 and 3 negate rows 0 and 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_w, n)).astype(np.float32)
    x[2:4] = -x[0:2]
    return x


@pytest.mark.parametrize("rows", [8, 24])
def test_sign_pack_plain_matches_pallas_3d(rows):
    x = _signs(rows * 1024, rows)
    want = jsign.sign_pack_3d(jnp.asarray(x.reshape(rows, 8, 128)), interpret=True)
    got = ops.sign_pack(_t(x))  # rows * 1024 elements: no pad unless rows % 8
    want = np.asarray(want).reshape(-1)
    np.testing.assert_array_equal(got.numpy()[:want.size], want)


@pytest.mark.parametrize("rows", [8, 24])
def test_sign_unpack_plain_matches_pallas_3d(rows):
    packed = np.random.default_rng(rows).integers(0, 256, rows * 128).astype(np.uint8)
    want = jsign.sign_unpack_3d(jnp.asarray(packed.reshape(rows, 128)), interpret=True)
    got = ops.sign_unpack(_t(packed), rows * 1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1))


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("n_w", [3, 4])
def test_sign_vote_plain_matches_pallas_3d(n_w, general):
    rows = 16
    packed = np.random.default_rng(n_w).integers(0, 256, (n_w, rows * 128)).astype(np.uint8)
    packed[2 % n_w] = packed[0] ^ 0xFF  # opposite votes: ties at W = 4
    w = (np.linspace(0.3, 2.1, n_w) if general else np.asarray([1, 0, 1, 1][:n_w])
         ).astype(np.float32)
    want = jwire.sign_vote_3d(jnp.asarray(packed.reshape(n_w, rows, 128)),
                              jnp.asarray(np.broadcast_to(w[:, None], (n_w, 128))),
                              interpret=True)
    got = ops.sign_vote(_t(packed), _t(w), rows * 1024).numpy()
    want = np.asarray(want).reshape(-1)
    if general:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_sign_pack_and_unpack_match_reference(n):
    x = _signs(n, n)
    want = np.asarray(jops.sign_pack(jnp.asarray(x)))
    got = ops.sign_pack(_t(x)).numpy()
    assert got.size == want.size == ops.sign_packed_bytes(n)
    np.testing.assert_array_equal(got, want)  # pad bytes included
    np.testing.assert_array_equal(ops.sign_unpack(_t(got), n).numpy(),
                                  np.asarray(jops.sign_unpack(jnp.asarray(want), n)))


def test_sign_pack_writes_into_a_stack_row():
    x = _signs(1000, 1)
    stack = torch.zeros((3, 1024), dtype=torch.uint8)
    out = ops.sign_pack(_t(x), out=stack[1])
    assert out.data_ptr() == stack[1].data_ptr()
    np.testing.assert_array_equal(stack[1].numpy(), np.asarray(jops.sign_pack(jnp.asarray(x))))
    assert not stack[0].any() and not stack[2].any()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("general", [False, True])
def test_sign_vote_matches_reference(n, general):
    x = _votes_data(n, 4, n)
    packed = np.stack([np.asarray(jops.sign_pack(jnp.asarray(r))) for r in x])
    w = np.asarray([0.25, 1.5, 0.75, 2.0] if general else [1, 1, 1, 1], np.float32)
    want = np.asarray(jops.sign_vote(jnp.asarray(packed), jnp.asarray(w), n=n))
    got = ops.sign_vote(_t(packed), _t(w), n).numpy()
    if general:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        assert (want == 0).any()  # 2-2 ties are in the data


# ---------------------------------------------------------------------------
# The 2-bit ternary wire: plain versions against the Pallas kernels and the
# reference's flat API.
# ---------------------------------------------------------------------------


def _tern_data(n, seed):
    """Normal draws with +0.0 and -0.0 planted, and noise u equal to the
    kernel's p = |x| * inv at every 13th element (u < p is strict: code 0)."""
    x, u = _data(n, seed)
    x[3::89] = -0.0
    inv = np.float32(1.0) / np.float32(max(np.abs(x).max(), np.float32(1e-30)))
    u[5::13] = np.abs(x[5::13]) * inv
    return x, u, inv


def _terns(shape, seed):
    """int8 codes in {-1, 0, 1}, with values outside it (-128..127) at every
    seventh element: they pack by the reference's predicates."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-1, 2, shape).astype(np.int8)
    flat = t.reshape(-1)
    flat[::7] = rng.integers(-128, 128, flat[::7].size)
    return t


@pytest.mark.parametrize("rows", [256, 512])
def test_terngrad_plain_matches_pallas_2d(rows):
    x, u, inv = _tern_data(rows * 128, rows)
    want = jtern.terngrad_2d(jnp.asarray(x.reshape(rows, 128)), jnp.asarray(u.reshape(rows, 128)),
                             jnp.full((1, 1), inv), interpret=True)
    got = torch.empty(x.size, dtype=torch.int8)
    ops.terngrad_codes_into(_t(x), _t(u), _s(inv), got)
    want = np.asarray(want).reshape(-1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[5::13] == 0).all() and set(np.unique(want)) == {-1, 0, 1}


@pytest.mark.parametrize("n", SIZES)
def test_terngrad_quantize_matches_reference(n):
    """Codes and smax bitwise: max|x| is exact in any order, and both sides
    multiply by the same reciprocal."""
    x, u, _ = _tern_data(n, n + 3)
    want_t, want_s = jops.terngrad_quantize(jnp.asarray(x), jnp.asarray(u))
    got_t, got_s = ops.terngrad_quantize(_t(x), _t(u))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("rows", [8, 24])
def test_tern_pack_plain_matches_pallas_3d(rows):
    t = _terns((rows, 4, 128), rows)
    want = jwire.tern_pack_3d(jnp.asarray(t), interpret=True)
    got = ops.tern_pack(_t(t.reshape(-1)))  # rows * 512 elements: no pad unless rows % 8
    want = np.asarray(want).reshape(-1)
    np.testing.assert_array_equal(got.numpy()[:want.size], want)


@pytest.mark.parametrize("n", SIZES)
def test_tern_pack_matches_reference(n):
    t = _terns(n, n)
    want = np.asarray(jops.tern_pack(jnp.asarray(t)))
    got = ops.tern_pack(_t(t)).numpy()
    assert got.size == want.size == ops.tern_packed_bytes(n)
    np.testing.assert_array_equal(got, want)  # pad bytes included


def test_tern_pack_writes_into_a_stack_row():
    t = _terns(1000, 1)
    stack = torch.zeros((3, 1024), dtype=torch.uint8)
    out = ops.tern_pack(_t(t), out=stack[1])
    assert out.data_ptr() == stack[1].data_ptr()
    np.testing.assert_array_equal(stack[1].numpy(), np.asarray(jops.tern_pack(jnp.asarray(t))))
    assert not stack[0].any() and not stack[2].any()


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("n_w", [3, 4])
def test_tern_acc_plain_matches_pallas_3d(n_w, general):
    """Random bytes, so every crumb value occurs (crumb 2 decodes to 0)."""
    rows = 16
    packed = np.random.default_rng(n_w + 10).integers(0, 256, (n_w, rows * 128)).astype(np.uint8)
    w = (np.linspace(0.3, 2.1, n_w) if general else np.asarray([1, 0, 1, 1][:n_w])
         ).astype(np.float32)
    want = jwire.tern_acc_3d(jnp.asarray(packed.reshape(n_w, rows, 128)),
                             jnp.asarray(np.broadcast_to(w[:, None], (n_w, 128))),
                             interpret=True)
    got = ops.tern_acc(_t(packed), _t(w), rows * 512).numpy()
    want = np.asarray(want).reshape(-1)
    if general:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("n_w", [3, 4])
def test_tern_acc_matches_reference(n, n_w):
    """Each worker's payload packed by the reference, one worker weighted 0;
    rtol 1e-6 with atol 1e-6 of the largest element (signed decodes cancel,
    and XLA sums the W terms in its own order)."""
    rng = np.random.default_rng(n + n_w)
    packed = np.stack([np.asarray(jops.tern_pack(jnp.asarray(rng.integers(-1, 2, n)
                                                             .astype(np.int8))))
                       for _ in range(n_w)])
    w = np.linspace(0.01, 0.05, n_w).astype(np.float32)
    w[1] = 0.0
    want = np.asarray(jops.tern_acc(jnp.asarray(packed), jnp.asarray(w), n=n))
    got = ops.tern_acc(_t(packed), _t(w), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_tern_wrappers_reject_bad_inputs():
    t = torch.zeros(5000, dtype=torch.int8)
    with pytest.raises(ValueError, match="packed"):  # one byte short of the padded payload
        ops.tern_pack(t, out=torch.empty(2047, dtype=torch.uint8))
    with pytest.raises(ValueError, match="tern"):  # codes must be int8
        ops.tern_pack(torch.zeros(5000))
    with pytest.raises(ValueError, match="packed"):  # 128 bytes cover 512 elements only
        ops.tern_acc(torch.zeros((2, 128), dtype=torch.uint8), torch.ones(2), 513)
    with pytest.raises(ValueError, match="weights"):
        ops.tern_acc(torch.zeros((2, 1024), dtype=torch.uint8), torch.ones(3), 10)
    with pytest.raises(ValueError, match="inv"):
        ops.terngrad_codes_into(torch.zeros(10), torch.zeros(10), torch.ones(2),
                                torch.empty(10, dtype=torch.int8))


# ---------------------------------------------------------------------------
# Threshold sparsification: the plain version against the Pallas kernel and
# the reference's flat API.
# ---------------------------------------------------------------------------


def _thresh_data(n, seed):
    """0.1 * N(0, 1) with +0.0, -0.0, NaN, +inf and -inf planted."""
    x = (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)
    x[::97] = 0.0
    x[3::89] = -0.0
    x[5::1001], x[7::1003], x[11::1009] = np.nan, np.inf, -np.inf
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("rows", [256, 768])
@pytest.mark.parametrize("tau", [0.0, 0.05, 10.0])
def test_threshold_plain_matches_pallas_2d(rows, tau):
    """Whole (256, 128) tiles: no pads, so the block counts agree at every tau."""
    x = _thresh_data(rows * 128, rows)
    want, want_counts = jthr.threshold_2d(jnp.asarray(x.reshape(rows, 128)),
                                          jnp.full((1, 1), tau, jnp.float32), interpret=True)
    got, counts = ops.threshold_blocks(_t(x), _s(tau))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want).reshape(-1))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts).reshape(-1))


@pytest.mark.parametrize("n", [1000, 100_003])
@pytest.mark.parametrize("tau", [0.0, 0.05, 10.0])
def test_threshold_sparsify_matches_reference(n, tau):
    """The flat API against ``repro.kernels.ops.threshold_sparsify``: masked
    values bitwise, nnz (``sum(|masked| > 0)``) equal.  Block counts: the
    reference pads its last tile with zeros, which it counts when tau <= 0,
    so they are compared with ``threshold_2d``'s at tau > 0 and with the
    counts of the unpadded input otherwise."""
    x = _thresh_data(n, n)
    want, want_nnz = jops.threshold_sparsify(jnp.asarray(x), tau)
    got, nnz = ops.threshold_sparsify(_t(x), tau)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert nnz.dtype == torch.int32 and int(nnz) == int(want_nnz)
    _, counts = ops.threshold_blocks(_t(x), tau)
    tile = ops.THRESH_BLOCK
    assert counts.shape == (-(-n // tile),)
    if tau > 0:
        x2 = np.pad(x, (0, (-n) % tile)).reshape(-1, 128)
        _, want_counts = jthr.threshold_2d(jnp.asarray(x2), jnp.full((1, 1), tau, jnp.float32),
                                           interpret=True)
        want_counts = np.asarray(want_counts).reshape(-1)
    else:
        keep = np.pad(np.abs(x) >= tau, (0, (-n) % tile))
        want_counts = keep.reshape(-1, tile).sum(1)
    np.testing.assert_array_equal(counts.numpy(), want_counts)


def test_threshold_reads_a_one_element_tau():
    x = _t(_thresh_data(5000, 1))
    got, counts = ops.threshold_blocks(x, torch.full((1,), 0.05))
    want, want_counts = ref.threshold(x, _s(0.05), ops.THRESH_BLOCK)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(counts, want_counts)


def test_threshold_wrapper_rejects_bad_inputs():
    x = torch.zeros(100)
    with pytest.raises(ValueError, match="tau"):  # one element
        ops.threshold_blocks(x, torch.ones(2))
    with pytest.raises(ValueError, match="tau"):  # on the launch's device
        ops.threshold_blocks(x, torch.ones((), device="meta"))
    with pytest.raises(ValueError, match="tau"):
        ops.threshold_blocks(x, torch.ones(1, dtype=torch.float64))


# ---------------------------------------------------------------------------
# On the card: every kernel against its plain version.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(100_003, 0), (4096, 1), (37, 0)])
def test_qsgd_kernel_matches_plain_on_card(cuda, n, offset):
    x, u = _data(n + offset, n)
    xt, ut = _t(x).to(cuda)[offset:], _t(u).to(cuda)[offset:]  # offset 1: scalar path
    inv = torch.reciprocal(torch.linalg.vector_norm(xt))
    before = ops.LAUNCHES["qsgd"]
    got = torch.empty(n, dtype=torch.int8, device=cuda)
    ops.qsgd_codes_into(xt, ut, inv, 16.0, got)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["qsgd"] == before + 1
    want = ref.qsgd_codes(xt, ut, inv, torch.tensor(16.0, device=cuda))
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(100_003, 0), (4096, 1)])
def test_qsgd_ef_kernel_matches_plain_on_card(cuda, n, offset):
    g, u = _data(n + offset, n)
    e, _ = _data(n + offset, n + 1, scale=0.05)
    gt, et, ut = (_t(a).to(cuda)[offset:] for a in (g, e, u))
    inv = torch.reciprocal(torch.linalg.vector_norm(et * 0.9 + gt))
    codes = torch.empty(n, dtype=torch.int8, device=cuda)
    e_new = torch.empty(n, device=cuda)
    ops.qsgd_ef_into(gt, et, ut, inv, 16.0, 0.9, codes, e_new)
    torch.cuda.synchronize()
    dev = dict(device=cuda)
    want_c, want_e = ref.qsgd_ef(gt, et, ut, inv, torch.tensor(16.0, **dev),
                                 torch.tensor(0.9, **dev))
    assert torch.equal(codes, want_c)
    torch.testing.assert_close(e_new, want_e, rtol=1e-6, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_w,n,ld", [(4, 100_003, 100_016), (3, 1001, 1001)])
def test_int8_acc_kernel_matches_plain_on_card(cuda, n_w, n, ld):
    rng = np.random.default_rng(n)
    codes = _t(rng.integers(-127, 128, (n_w, ld)).astype(np.int8)).to(cuda)[:, :n]
    w = torch.linspace(0.01, 0.05, n_w, device=cuda)
    got = ops.int8_weighted_sum(codes, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.int8_acc(codes, w), rtol=1e-6, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(100_003, 0), (8192, 1), (37, 0)])
def test_sign_pack_unpack_kernels_match_plain_on_card(cuda, n, offset):
    x = _t(_signs(n + offset, n)).to(cuda)[offset:]  # offset 1: unaligned scalar path
    before = dict(ops.LAUNCHES)
    packed = ops.sign_pack(x)
    values = ops.sign_unpack(packed, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sign_pack"] == before["sign_pack"] + 1
    assert ops.LAUNCHES["sign_unpack"] == before["sign_unpack"] + 1
    want = ref.sign_pack(x, ops.sign_packed_bytes(n))
    assert torch.equal(packed, want)  # pad bytes included
    assert torch.equal(values, ref.sign_unpack(want, n))


@pytest.mark.gpu
@pytest.mark.parametrize("n,ld", [(100_003, 13 * 1024), (37, 1024), (5000, 1028)])
@pytest.mark.parametrize("general", [False, True])
def test_sign_vote_kernel_matches_plain_on_card(cuda, n, ld, general):
    rng = np.random.default_rng(n)
    nbytes = ops.sign_packed_bytes(n)
    stack = _t(rng.integers(0, 256, (4, ld)).astype(np.uint8)).to(cuda)[:, :nbytes]
    stack[2] = stack[0] ^ 0xFF  # ties
    w = torch.tensor([0.25, 1.5, 0.75, 2.0] if general else [1.0, 0.0, 1.0, 1.0], device=cuda)
    got = ops.sign_vote(stack, w, n)
    torch.cuda.synchronize()
    want = ref.sign_vote(stack, w, n)
    if general:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(100_003, 0), (4096, 1), (37, 0)])
def test_terngrad_kernel_matches_plain_on_card(cuda, n, offset):
    x, u, _ = _tern_data(n + offset, n)
    xt, ut = _t(x).to(cuda)[offset:], _t(u).to(cuda)[offset:]  # offset 1: scalar path
    inv = torch.reciprocal(torch.clamp_min(torch.max(torch.abs(xt)), 1e-30))
    before = ops.LAUNCHES["terngrad"]
    got = torch.empty(n, dtype=torch.int8, device=cuda)
    ops.terngrad_codes_into(xt, ut, inv, got)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["terngrad"] == before + 1
    assert torch.equal(got, ref.terngrad_codes(xt, ut, inv))


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(100_003, 0), (4096, 1), (37, 0)])
def test_tern_pack_kernel_matches_plain_on_card(cuda, n, offset):
    t = _t(_terns(n + offset, n)).to(cuda)[offset:]  # offset 1: unaligned scalar path
    before = ops.LAUNCHES["tern_pack"]
    packed = ops.tern_pack(t)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tern_pack"] == before + 1
    assert torch.equal(packed, ref.tern_pack(t, ops.tern_packed_bytes(n)))  # pads included


@pytest.mark.gpu
# ld 2050: rows off 4-byte boundaries, the scalar read path
@pytest.mark.parametrize("n,ld", [(100_003, 25 * 1024), (37, 1024), (5000, 2050)])
@pytest.mark.parametrize("general", [False, True])
def test_tern_acc_kernel_matches_plain_on_card(cuda, n, ld, general):
    rng = np.random.default_rng(n)
    nbytes = ops.tern_packed_bytes(n)
    stack = _t(rng.integers(0, 256, (4, ld)).astype(np.uint8)).to(cuda)[:, :nbytes]
    w = torch.tensor([0.25, 1.5, 0.75, 2.0] if general else [1.0, 0.0, 1.0, 1.0], device=cuda)
    before = ops.LAUNCHES["tern_acc"]
    got = ops.tern_acc(stack, w, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tern_acc"] == before + 1
    want = ref.tern_acc(stack, w, n)
    if general:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(100_003, 0), (4096, 1), (37, 0), (2 * 32768, 0)])
@pytest.mark.parametrize("tau", [0.0, 0.05, 10.0])
def test_threshold_kernel_matches_plain_on_card(cuda, n, offset, tau):
    xt = _t(_thresh_data(n + offset, n)).to(cuda)[offset:]  # offset 1: scalar path
    t = torch.full((1,), tau, device=cuda)
    before = ops.LAUNCHES["threshold"]
    got, counts = ops.threshold_blocks(xt, t)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["threshold"] == before + 1
    want, want_counts = ref.threshold(xt, t.reshape(()), ops.THRESH_BLOCK)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(counts, want_counts)


@pytest.mark.gpu
@pytest.mark.parametrize("n,levels", [(100_003, 16), (3_000_000, 1000)])
def test_top_k_on_card_matches_cpu_on_ties(cuda, n, levels):
    """The stable descending sort keeps lax.top_k's tie order on the card too."""
    score = _t(np.random.default_rng(n).integers(0, levels, n).astype(np.float32) / levels)
    for k in (1, n // 100, n // 2):
        assert torch.equal(top_k(score.to(cuda), k).cpu(), top_k(score, k))
