"""The chunked form of kernel ``wkv6_bwd`` (RWKV6's backward on the card).

``ref.wkv6_bwd_states`` and ``ref.wkv6_backward_chunked`` repeat the two
launches' arithmetic in plain PyTorch: the states at the boundaries of
chunks of 64 steps, then inside each chunk the gradient of the state
carried backward and the state forward sub-chunk by sub-chunk, each
sub-chunk of 16 steps computed from its two boundary states, with the decay
taken as running products of w (no division by w).  The kernel cannot run
on a CPU, so this is where the algorithm's numerics are shown: the same
numpy inputs from a seed go through it, through the sequential
``ref.wkv6_backward`` and through ``jax.vjp`` of the reference's
``wkv_scan``.  Every gradient is held within rtol 1e-4 / atol 1e-5 x its
largest magnitude (the sums run in other orders), at S = 1, inside one
sub-chunk, at a chunk's length and one step either side of it, ragged;
hd 16 and 32; w holding 0, 1 and 1e-3; dsT given and absent.  A run over S
equals two runs joined through ds0 / dsT, and the boundary states equal
the sequential scan's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as JRW
from repro_torch.kernels import ops, probe, ref
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

L = ref.WKV6_BWD_CHUNK
NAMES = ("r", "k", "v", "w", "u", "s0")


def _inputs(B, S, H, hd, seed):
    """r, k, v, w (B, S, H, hd), u (H, hd), s0 (B, H, hd, hd), dy (B, S, H,
    hd), dsT (B, H, hd, hd) as f32 numpy; w holds 0, 1 and 1e-3 in some
    channels and a run of w = 1 (no decay) in the first ones."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, hd)))) * 0.5 + 0.4).astype(np.float32)
    w[:, ::7, :, ::3] = 0.0
    w[:, 1::5, :, 1::3] = 1.0
    w[:, 2::3, :, 2::3] = 1e-3
    w[:, 20:60, :, :4] = 1.0
    u = rng.standard_normal((H, hd)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    dy = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dsT = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    return (r, k, v, w, u, s0), dy, dsT


def _assert_close(got, want, what):
    for name, g, wv in zip(NAMES, got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(np.asarray(g), wv, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(wv).max()), err_msg=f"{what} d{name}")


@pytest.mark.parametrize("B,S,H,hd,with_dsT", [
    (2, 1, 2, 16, True), (1, 11, 2, 32, False), (2, 37, 2, 16, True), (1, L, 2, 16, True),
    (1, L - 1, 1, 32, True), (2, L + 1, 2, 16, False), (1, 2 * L + 19, 1, 16, True)])
def test_chunked_backward_matches_the_scan_and_the_reference_vjp(B, S, H, hd, with_dsT):
    ins, dy, dsT = _inputs(B, S, H, hd, seed=S + hd)
    tins = [torch.from_numpy(a) for a in ins]
    tdy = torch.from_numpy(dy)
    tdsT = torch.from_numpy(dsT) if with_dsT else None
    got = ref.wkv6_backward_chunked(*tins, tdy, tdsT)
    assert all(g.dtype == torch.float32 for g in got)
    assert [tuple(g.shape) for g in got] == [(B, S, H, hd)] * 4 + [(H, hd), (B, H, hd, hd)]
    _assert_close(got, ref.wkv6_backward(*tins, tdy, tdsT), "against ref.wkv6_backward")
    _, vjp = jax.vjp(JRW.wkv_scan, *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dsT if with_dsT else np.zeros_like(dsT))))
    _assert_close(got, want, "against jax.vjp(wkv_scan)")


def test_no_division_by_w():
    """A decay of exactly 0 everywhere in a channel, and of 1e-30 (whose
    running products underflow), keeps every gradient finite and equal to
    the scan's."""
    ins, dy, dsT = _inputs(1, 2 * L + 5, 2, 16, seed=3)
    ins[3][:, :, 0, :5] = 0.0
    ins[3][:, :, 1, 5:9] = 1e-30
    tins = [torch.from_numpy(a) for a in ins]
    args = (*tins, torch.from_numpy(dy), torch.from_numpy(dsT))
    got = ref.wkv6_backward_chunked(*args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _assert_close(got, ref.wkv6_backward(*args), "w at 0 and 1e-30")


@pytest.mark.parametrize("S,cut", [(L + 9, L), (2 * L + 3, 37)])
def test_a_run_equals_two_runs_joined_through_the_state(S, cut):
    """The gradient over S equals the gradient over the last S - cut steps
    (from the state the first cut steps leave) followed by the first cut
    steps with dsT = the second run's ds0; their du add."""
    ins, dy, dsT = _inputs(2, S, 2, 16, seed=S)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in ins)
    tdy, tdsT = torch.from_numpy(dy), torch.from_numpy(dsT)
    whole = ref.wkv6_backward_chunked(r, k, v, w, u, s0, tdy, tdsT)
    first, second = slice(None, cut), slice(cut, None)
    _, s_mid = ref.wkv6(r[:, first], k[:, first], v[:, first], w[:, first], u, s0)
    late = ref.wkv6_backward_chunked(r[:, second], k[:, second], v[:, second], w[:, second], u,
                                     s_mid, tdy[:, second], tdsT)
    early = ref.wkv6_backward_chunked(r[:, first], k[:, first], v[:, first], w[:, first], u, s0,
                                      tdy[:, first], late[5])
    joined = [torch.cat([a, b], dim=1) for a, b in zip(early[:4], late[:4])]
    joined += [early[4] + late[4], early[5]]
    _assert_close(joined, whole, "two runs joined")


@pytest.mark.parametrize("S", [1, L, 2 * L + 19])
def test_boundary_states_are_the_scans(S):
    """wkv6_bwd_states' P before chunk c is the scan's state after c chunks;
    its D after chunk c is the ds0 of the backward over the steps after it;
    its ds0 is the whole backward's.  The wrapper on CPU tensors is this
    plain version."""
    ins, dy, dsT = _inputs(1, S, 2, 16, seed=S + 1)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in ins)
    tdy, tdsT = torch.from_numpy(dy), torch.from_numpy(dsT)
    P, D, ds0 = ref.wkv6_bwd_states(r, k, v, w, s0, tdy, tdsT)
    C = -(-S // L)
    assert P.shape == D.shape == (1, 2, C, 16, 16)
    tol = dict(rtol=1e-4, atol=1e-6)
    for c in range(C):
        sc = s0 if c == 0 else ref.wkv6(r[:, :c * L], k[:, :c * L], v[:, :c * L],
                                        w[:, :c * L], u, s0)[1]
        np.testing.assert_allclose(P[:, :, c].numpy(), sc.numpy(), **tol, err_msg=f"P {c}")
        tail = slice((c + 1) * L, None)
        if (c + 1) * L < S:
            _, s_end = ref.wkv6(r[:, :(c + 1) * L], k[:, :(c + 1) * L], v[:, :(c + 1) * L],
                                w[:, :(c + 1) * L], u, s0)
            d_end = ref.wkv6_backward(r[:, tail], k[:, tail], v[:, tail], w[:, tail], u, s_end,
                                      tdy[:, tail], tdsT)[5]
        else:
            d_end = tdsT
        np.testing.assert_allclose(D[:, :, c].numpy(), d_end.numpy(), **tol, err_msg=f"D {c}")
    np.testing.assert_allclose(ds0.numpy(), ref.wkv6_backward(r, k, v, w, u, s0, tdy, tdsT)[5]
                               .numpy(), **tol)
    for a, b in zip(ops.wkv6_bwd_states(r, k, v, w, s0, tdy, tdsT), (P, D, ds0)):
        assert torch.equal(a, b)


def test_probe_finds_each_phase_of_the_backward_once():
    """``python -m repro_torch.kernels.probe bwd`` compiles each phase of
    launches wkv6_bwd and wkv6_bwd_states out by its lines of wkv6_bwd.cu:
    every phase's line is there (the three loops of M, PD and GV share
    theirs), and no other phase's line holds it."""
    src = (Path(__file__).resolve().parents[1]
           / "src/repro_torch/kernels/csrc/wkv6_bwd.cu").read_text()
    lines = [line for _, line, _ in probe.BWD_PHASES + probe.STATES_PHASES]
    for name, line, cut in probe.BWD_PHASES + probe.STATES_PHASES:
        assert src.count(line) == (3 if name.startswith("M, PD, GV") else 1), name
        assert cut != line and sum(line in other for other in lines) == 1, name
