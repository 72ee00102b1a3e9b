"""The chunked form of kernel ``wkv6`` (its prefill path on the card).

``ref.wkv6_chunked`` repeats the kernel's arithmetic in plain PyTorch: the
log2 decay clamped below and summed per sub-chunk of 16 steps, the state
term, the off-diagonal blocks factored through a sub-chunk's last step, the
diagonal blocks element by element and the state carried sub-chunk by
sub-chunk.  The kernel cannot run on a CPU, so this is where the
algorithm's numerics are shown: the same numpy inputs from a seed go
through it and through the reference's Pallas ``wkv6_chunked`` (interpret
mode) and its sequential ``ref.wkv6_ref``.  Tolerances: y within rtol 3e-4 /
atol 3e-5 (the reference's own kernel test); sT within rtol 1e-4 / atol
1e-5 x max|sT| (the chunked form reorders the sums and rounds exp2/log2, so
sT is no longer bitwise).  On the card (``gpu`` marker) the kernel is held
against the plain scan and the twin at the same tolerances, and the
recurrent design, which S = 1 takes, keeps sT bitwise.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, probe, ref
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ROOT = Path(__file__).resolve().parents[1]
Y_TOL = dict(rtol=3e-4, atol=3e-5)
S_RTOL, S_ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    return torch.device("cuda")


def _inputs(B, S, H, hd, seed, edge=False):
    """r, k, v, w (B, S, H, hd), u (H, hd), s0 (B, H, hd, hd) as f32 numpy, w
    in (0.4, 0.9); ``edge`` plants w = 0.0, 1.0 and 1e-3 (with 1e-3 the
    unfactored 2^-G[s] of a 16-step sub-chunk would overflow) and a run of
    w = 1 (no decay at all) in the first channels."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, hd)))) * 0.5 + 0.4).astype(np.float32)
    if edge:
        w[:, ::7, :, ::3] = 0.0
        w[:, 1::5, :, 1::3] = 1.0
        w[:, 2::3, :, 2::3] = 1e-3
        w[:, 20:60, :, :8] = 1.0
    u = rng.standard_normal((H, hd)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    return r, k, v, w, u, s0


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def _state_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=S_RTOL,
                               atol=S_ATOL * np.abs(want).max())


def _check_twin(B, S, H, hd, dtype, seed, edge, pallas=True, **kw):
    r, k, v, w, u, s0 = _inputs(B, S, H, hd, seed, edge)
    if dtype == torch.bfloat16:
        r, k, v = _bf16(r), _bf16(k), _bf16(v)
    tt = lambda a, dt=torch.float32: torch.from_numpy(a).to(dt)  # noqa: E731
    y, sT = ref.wkv6_chunked(tt(r, dtype), tt(k, dtype), tt(v, dtype), tt(w), tt(u), tt(s0), **kw)
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == (B, S, H, hd) and sT.shape == (B, H, hd, hd)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sT).all())
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    wants = [jref.wkv6_ref(*jargs)] + ([jops.wkv6(*jargs, chunk=64)] if pallas else [])
    for want_y, want_s in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **Y_TOL)
        _state_close(sT.numpy(), want_s)


@pytest.mark.parametrize("S", [1, 16, 37, 64, 100, 130])
@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_twin_matches_reference(S, hd, dtype):
    _check_twin(1, S, 2, hd, dtype, seed=S * 3 + hd, edge=False)


@pytest.mark.parametrize("S", [37, 130])
@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_twin_holds_decay_edge_cases(S, hd, dtype):
    """w of exactly 0.0 (log2 clamped to -100), exactly 1.0 (an exact 0) and
    1e-3, and 40 steps without decay, against the sequential scans."""
    _check_twin(2, S, 1, hd, dtype, seed=S + hd, edge=True)


@pytest.mark.parametrize("chunk,sub", [(32, 16), (64, 16), (64, 8), (16, 16)])
def test_chunked_twin_any_split_is_the_same_function(chunk, sub):
    """More than two sub-chunks per chunk exercise the factor through the
    sub-chunks in between (2^(T_{p+1} + ... + T_{q-1}))."""
    _check_twin(1, 70, 2, 16, torch.float32, seed=chunk + sub, edge=True, pallas=False,
                chunk=chunk, sub=sub)


def test_chunked_twin_carries_state_across_calls():
    """Two calls over 45 + 55 steps, the state carried, against one call over
    all 100: the chunk boundaries move, the function does not."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _inputs(1, 100, 2, 16, 5, edge=True))
    y, sT = ref.wkv6_chunked(r, k, v, w, u, s0)
    ya, sa = ref.wkv6_chunked(r[:, :45], k[:, :45], v[:, :45], w[:, :45], u, s0)
    yb, sb = ref.wkv6_chunked(r[:, 45:], k[:, 45:], v[:, 45:], w[:, 45:], u, sa)
    np.testing.assert_allclose(torch.cat([ya, yb], 1).numpy(), y.numpy(), **Y_TOL)
    _state_close(sb.numpy(), sT.numpy())


def test_chunked_twin_rejects_ragged_split():
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _inputs(1, 4, 1, 16, 1))
    with pytest.raises(ValueError, match="multiple"):
        ref.wkv6_chunked(r, k, v, w, u, s0, chunk=24, sub=16)


def test_kernel_constants_match_the_twin():
    """The chunk, the sub-chunk and the log2 floor in wkv6.cu are the ones
    the wrapper dispatches on and the twin computes with."""
    src = (ROOT / "src/repro_torch/kernels/csrc/wkv6.cu").read_text()
    const = lambda name: re.search(rf"constexpr \w+ {name} = (-?[0-9.]+)f?;", src).group(1)  # noqa: E731
    assert int(const("kC")) == ops.WKV6_CHUNK == 32
    assert int(const("kL")) == 16
    assert float(const("kLog2Floor")) == ref.WKV6_LOG2_FLOOR


def test_probe_finds_each_phase_once():
    """``python -m repro_torch.kernels.probe phases`` compiles each phase of
    the chunked design out by its line of wkv6.cu: every line is there, once."""
    src = (ROOT / "src/repro_torch/kernels/csrc/wkv6.cu").read_text()
    for name, line, cut in probe.PHASES:
        assert src.count(line) == 1 and cut != line, name


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


def _card_inputs(B, S, H, hd, dtype, seed, edge, device):
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(device) for a in _inputs(B, S, H, hd, seed, edge))
    return tuple(t.to(dtype) for t in (r, k, v)) + (w, u.to(dtype), s0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd,edge", [(2, 130, 4, 80, True), (1, 1000, 32, 80, False),
                                           (2, 33, 2, 16, True), (1, 64, 3, 64, True),
                                           (2, 100, 2, 32, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_kernel_matches_plain_and_twin_on_card(cuda, B, S, H, hd, edge, dtype):
    args = _card_inputs(B, S, H, hd, dtype, 11, edge, cuda)
    ops.reset_launches()
    y, sT = ops.wkv6(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv6"] == 1
    for want_y, want_s in (ref.wkv6(*args), ref.wkv6_chunked(*args)):
        torch.testing.assert_close(y, want_y, **Y_TOL)
        torch.testing.assert_close(sT, want_s, rtol=S_RTOL,
                                   atol=S_ATOL * float(want_s.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recurrent_design_keeps_decode_bitwise_on_card(cuda, dtype):
    """S = 1 (a decode step) and S = 31 take the recurrent design: sT bit
    for bit the plain scan's; forced onto a long S, it agrees with the
    chunked design within the stated tolerance."""
    for S in (1, ops.WKV6_CHUNK - 1):
        args = _card_inputs(8, S, 4, 80, dtype, 12, True, cuda)
        y, sT = ops.wkv6(*args)
        want_y, want_s = ref.wkv6(*args)
        assert torch.equal(sT, want_s)
        torch.testing.assert_close(y, want_y, **Y_TOL)
    args = _card_inputs(2, 300, 4, 80, dtype, 13, True, cuda)
    y0, s0 = ops._wkv6_launch(*args, chunked=False)
    y1, s1 = ops._wkv6_launch(*args, chunked=True)
    torch.testing.assert_close(y1, y0, **Y_TOL)
    torch.testing.assert_close(s1, s0, rtol=S_RTOL, atol=S_ATOL * float(s0.abs().max()))


@pytest.mark.gpu
def test_chunked_kernel_resources_on_card(cuda):
    """At hd 80 with bf16 r, k, v the chunked design keeps two CTAs resident
    per SM, so the prefill's 256 heads run in one wave."""
    got = ops.wkv6_chunked_info(80, True)
    assert got["ctas_per_sm"] >= 2 and got["dynamic_smem"] <= 113 * 1024, got
