"""The port's RWKV6 family and serving path against the JAX package: kernel
``wkv6`` (its plain version on the CPU) against the reference's Pallas
kernel in interpret mode and its ``ref.wkv6_ref``; ``rwkv_block`` and
``rwkv_channel_mix``; ``prefill`` and greedy ``decode_step`` through both
packages' ``build_serve``; the full-width parameter tree; the launcher.

Inputs are made with numpy from a seed and fed to both packages, the
reference's weights carried across with ``repro_torch.interop``.
Tolerances (f32 on the CPU; the frameworks sum products in other orders):
the recurrence rtol 3e-4 / atol 3e-5 (the reference's own kernel test);
the blocks, the last hidden state and the caches rtol 1e-4 with an atol of
1e-5 times the tensor's largest magnitude (outputs of sums over hundreds of
terms, compared elementwise also where they cancel to near zero); greedy
tokens equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as jget
from repro.configs.base import InputShape as JInputShape
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.mesh import make_test_mesh
from repro.models import rwkv as JRW
from repro.models import transformer as JT
from repro.models.sharding import AxisCtx
from repro.train.steps import build_serve as jbuild_serve
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ops, ref
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.models.sharding import check_ported
from repro_torch.train.steps import build_serve
from repro_torch.utils.tree import flatten_with_paths
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    return torch.device("cuda")


def _wkv_inputs(B, S, H, hd, seed, s0_scale=0.1):
    """r, k, v, w (B, S, H, hd), u (H, hd), s0 (B, H, hd, hd) as f32 numpy,
    w in (0.4, 0.9) like the reference's kernel test."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, hd)))) * 0.5 + 0.4).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * s0_scale
    return r, k, v, w, u, s0


def _bf16(a):
    """numpy f32 -> the bf16-rounded values, as f32 numpy (both packages
    widen bf16 exactly)."""
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# (a) kernel wkv6 (its plain version on the CPU) against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 32, 1, 16, 16), (2, 96, 3, 16, 32), (1, 64, 2, 64, 64), (2, 100, 2, 32, 32),
    (2, 1, 2, 32, 64),  # one decode step from a nonzero state
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_matches_reference(B, S, H, hd, chunk, dtype):
    r, k, v, w, u, s0 = _wkv_inputs(B, S, H, hd, seed=S * 7 + hd)
    if dtype == torch.bfloat16:
        r, k, v = _bf16(r), _bf16(k), _bf16(v)
    tt = lambda a, dt=torch.float32: torch.from_numpy(a).to(dt)  # noqa: E731
    y, sT = ops.wkv6(tt(r, dtype), tt(k, dtype), tt(v, dtype), tt(w), tt(u), tt(s0),
                     chunk=chunk)
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == (B, S, H, hd) and sT.shape == (B, H, hd, hd)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    for want_y, want_s in (jops.wkv6(*jargs, chunk=chunk), jref.wkv6_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=3e-4, atol=3e-5)
        np.testing.assert_allclose(sT.numpy(), np.asarray(want_s), rtol=3e-4, atol=3e-5)


def test_wkv6_is_the_model_scan_and_carries_state():
    """ops.wkv6 on the CPU is the model's wkv_scan; two calls over halves of
    the sequence, the state carried, equal one call over all of it."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(2, 20, 2, 16, seed=5))
    y, sT = ops.wkv6(r, k, v, w, u, s0)
    y2, s2 = RW.wkv_scan(r, k, v, w, u, s0)
    assert torch.equal(y, y2) and torch.equal(sT, s2)
    ya, sa = ops.wkv6(r[:, :9], k[:, :9], v[:, :9], w[:, :9], u, s0)
    yb, sb = ops.wkv6(r[:, 9:], k[:, 9:], v[:, 9:], w[:, 9:], u, sa)
    assert torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(sb, sT)


@pytest.mark.parametrize("bad", ["shape_k", "shape_u", "shape_s0", "dtype_mixed", "dtype_int",
                                 "empty"])
def test_wkv6_wrapper_rejects_bad_inputs(bad):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(1, 4, 2, 16, seed=1))
    if bad == "shape_k":
        k = k[:, :3]
    elif bad == "shape_u":
        u = u[:1]
    elif bad == "shape_s0":
        s0 = s0[..., :8]
    elif bad == "dtype_mixed":
        k = k.to(torch.bfloat16)
    elif bad == "dtype_int":
        r, k, v = (t.to(torch.int32) for t in (r, k, v))
    else:
        r, k, v, w = (t[:, :0] for t in (r, k, v, w))
    with pytest.raises(ValueError, match="wkv6"):
        ops.wkv6(r, k, v, w, u, s0)


# ---------------------------------------------------------------------------
# (b) rwkv_block and rwkv_channel_mix against the reference's.
# ---------------------------------------------------------------------------


def _reduced(**upd):
    return get_config("rwkv6-3b").reduced().with_updates(**upd)


def _carried(cfg, **upd):
    """The reference's initial parameters for ``cfg`` (reduced rwkv6-3b, f32)
    and the port's copy of them."""
    jcfg = jget("rwkv6-3b").reduced().with_updates(**upd)
    jparams = JT.init_params(jcfg, jax.random.key(0), 1)
    flat = {k: np.asarray(v) for k, v in jflatten(jparams).items()}
    return jcfg, jparams, interop.params_from_numpy(flat, cfg, "cpu")


def _run_jax(fn, *args):
    mesh = make_test_mesh(1, 1)
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args), out_specs=P(),
                          check_vma=False))
    return jax.tree.map(np.asarray, f(*args))


def _atol(want) -> float:
    return ATOL * max(1.0, float(np.max(np.abs(want)))) if np.size(want) else ATOL


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=_atol(want),
                               err_msg=what)


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_block_and_channel_mix_match_reference(carried):
    cfg = _reduced()
    jcfg, jparams, params = _carried(cfg)
    jp = jparams["blocks"][0]["0"]
    p = params["blocks"][0]["0"]
    B, S, d = 2, 12, cfg.d_model
    H, hd = p["w0"].shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    # trained-like decay biases and mixes, so the data-dependent paths matter
    for name, scale in (("w0", 0.5), ("mu", 0.3), ("mu_base", 0.3), ("cm_mu_k", 0.3),
                        ("cm_mu_r", 0.3)):
        a = rng.standard_normal(p[name].shape).astype(np.float32) * scale
        jp = {**jp, name: jnp.asarray(a)}
        p = {**p, name: torch.from_numpy(a)}
    state = last = None
    jstate = jlast = None
    if carried:
        shift = rng.standard_normal((B, d)).astype(np.float32)
        wkv = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
        last_np = rng.standard_normal((B, d)).astype(np.float32)
        state = {"shift": torch.from_numpy(shift), "wkv": torch.from_numpy(wkv)}
        jstate = {"shift": jnp.asarray(shift), "wkv": jnp.asarray(wkv)}
        last, jlast = torch.from_numpy(last_np), jnp.asarray(last_np)
    ax = AxisCtx()
    for use_kernel in (False, True):
        want_out, want_state = _run_jax(
            lambda pp, xx, st: JRW.rwkv_block(jcfg, pp, xx, ax, st, use_kernel=use_kernel),
            jp, jnp.asarray(x), jstate)
        out, new = RW.rwkv_block(cfg, p, torch.from_numpy(x), state, use_kernel=use_kernel)
        _close(out, want_out, f"time mix out, use_kernel={use_kernel}")
        _close(new["wkv"], want_state["wkv"], "wkv state")
        assert torch.equal(new["shift"], torch.from_numpy(x[:, -1]))
    want_cm, want_last = _run_jax(
        lambda pp, xx, ll: JRW.rwkv_channel_mix(jcfg, pp, xx, ax, ll), jp, jnp.asarray(x), jlast)
    cm, new_last = RW.rwkv_channel_mix(cfg, p, torch.from_numpy(x), last)
    _close(cm, want_cm, "channel mix out")
    np.testing.assert_array_equal(new_last.numpy(), want_last)


def test_block_kernel_flag_is_the_same_recurrence_on_cpu():
    """On CPU tensors use_kernel=True reaches ops.wkv6's plain version: the
    same numbers as the plain scan, and no launch is counted."""
    cfg = _reduced()
    params = T.init_params(cfg, seed=1, device="cpu")
    p = params["blocks"][0]["0"]
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    ops.reset_launches()
    a, sa = RW.rwkv_block(cfg, p, x, use_kernel=True)
    b, sb = RW.rwkv_block(cfg, p, x, use_kernel=False)
    assert torch.equal(a, b) and torch.equal(sa["wkv"], sb["wkv"])
    assert ops.LAUNCHES["wkv6"] == 0


# ---------------------------------------------------------------------------
# (c) prefill and greedy decode against the reference's build_serve.
# ---------------------------------------------------------------------------


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in jflatten(tree).items()}


@pytest.mark.parametrize("scan_layers", [False, True])
def test_prefill_and_decode_match_reference(scan_layers):
    B, S, steps = 2, 24, 4
    cfg = _reduced(scan_layers=scan_layers)
    jcfg, jparams, params = _carried(cfg, scan_layers=scan_layers)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jsb = jbuild_serve(jcfg, make_test_mesh(1, 1), JInputShape("t", S + steps, B, "decode"))
    jlast, jcache = jsb.prefill_step(jparams, {"tokens": jnp.asarray(toks)})
    jcache_np = _flat_np(jcache)

    sb = build_serve(cfg, InputShape("t", S + steps, B, "decode"), "cpu")
    last, cache = sb.prefill_step(params, {"tokens": toks})
    _close(last, np.asarray(jlast), "last hidden")
    got = flatten_with_paths(cache)
    assert list(got) == list(jcache_np)
    for path, t in got.items():
        assert tuple(t.shape) == jcache_np[path].shape, path
        _close(t.to(torch.float32), jcache_np[path].astype(np.float32), path)
    assert int(cache["pos"]) == S

    # decode from the reference's own cache, each package greedily
    cache = interop.cache_from_numpy(jcache_np, cache)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    jtok = jnp.zeros((B, 1), jnp.int32)
    for t in range(steps):
        tok, cache = sb.serve_step(params, cache, tok)
        jtok, jcache = jsb.serve_step(jparams, jcache, jtok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), err_msg=f"step {t}")
    assert int(cache["pos"]) == S + steps
    for path, want in _flat_np(jcache).items():
        _close(flatten_with_paths(cache)[path].to(torch.float32), want.astype(np.float32), path)


def test_decode_leaves_its_input_cache_alone():
    cfg = _reduced()
    params = T.init_params(cfg, seed=2, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    _, cache = T.prefill(cfg, params, {"tokens": toks})
    before = {k: v.clone() for k, v in flatten_with_paths(cache).items()}
    T.decode_step(cfg, params, cache, toks[:, :1])
    for k, v in flatten_with_paths(cache).items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# (d) the full-width parameter tree; (e) the launcher.
# ---------------------------------------------------------------------------


def test_full_width_param_tree_matches_reference():
    """rwkv6-3b at published width: the reference's 23 leaves, paths and
    shapes (from the defs alone, nothing allocated)."""
    jabs, _, _ = JT.abstract_params(jget("rwkv6-3b"), 1)
    want = {k: tuple(v.shape) for k, v in jflatten(jabs).items()}
    got = {k: tuple(d.shape)
           for k, d in flatten_with_paths(T.param_defs(get_config("rwkv6-3b"))).items()}
    assert list(got) == list(want)
    assert got == want
    assert len(got) == 23 and sum(int(np.prod(s)) for s in got.values()) == 2_931_758_080


def test_config_matches_reference():
    want = dataclasses.asdict(jget("rwkv6-3b"))
    assert dataclasses.asdict(get_config("rwkv6-3b")) == want
    assert dataclasses.asdict(_reduced()) == dataclasses.asdict(jget("rwkv6-3b").reduced())


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "rwkv6-3b", "--reduced",
         "--device", "cpu", "--prompt-len", "16", "--batch", "2", "--decode", "5"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("prefill 16x2: ") and lines[0].endswith(" ms")
    assert lines[1].startswith("decoded 5 tokens/seq in ") and "tok/s total" in lines[1]
    sample = eval(lines[2].removeprefix("sample: "))  # noqa: S307 (a printed list of ints)
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)


# ---------------------------------------------------------------------------
# What the serving path and the trainer refuse.
# ---------------------------------------------------------------------------


def test_dense_serving_is_refused():
    """RWKV6's sequence-parallel prefill is refused: the reference's
    ``prefill_seqpar`` is dense-only (the dense family's runs,
    tests/test_torch_seqpar.py)."""
    bad = _reduced(seq_par=True)
    with pytest.raises(NotImplementedError, match="seq_par prefill runs dense models"):
        build_serve(bad, InputShape("t", 8, 2, "decode"), "cpu")
    params = T.init_params(_reduced(), seed=0, device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="seq_par prefill runs dense models"):
        T.prefill(bad, params, {"tokens": tokens})


@pytest.mark.parametrize("upd", [dict(attn_kind="gqa"), dict(rope_type="rope"),
                                 dict(logits_softcap=30.0)])
def test_unported_rwkv_options_are_refused(upd):
    with pytest.raises(NotImplementedError):
        check_ported(_reduced(**upd))


# ---------------------------------------------------------------------------
# (f) On the card.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd", [(1, 32, 1, 16), (2, 100, 2, 32), (1, 1, 32, 80),
                                      (2, 37, 3, 64), (2, 70, 4, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain_on_card(cuda, B, S, H, hd, dtype):
    """y within rtol 3e-4 / atol 3e-5 (sums in another order).  Below
    ``ops.WKV6_CHUNK`` steps the recurrent design rounds each step of S as
    the plain version's w*S + kv: sT bitwise; from it on the chunked design
    reorders the sums and rounds exp2/log2: sT within rtol 1e-4 / atol 1e-5
    x max|sT|."""
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda) for a in _wkv_inputs(B, S, H, hd, 9))
    r, k, v, u = (t.to(dtype) for t in (r, k, v, u))
    ops.reset_launches()
    y, sT = ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv6"] == 1
    want_y, want_s = ref.wkv6(r, k, v, w, u, s0)
    if S < ops.WKV6_CHUNK:
        assert torch.equal(sT, want_s)
    else:
        torch.testing.assert_close(sT, want_s, rtol=1e-4, atol=1e-5 * float(want_s.abs().max()))
    torch.testing.assert_close(y, want_y, rtol=3e-4, atol=3e-5)


@pytest.mark.gpu
def test_wkv6_kernel_takes_offset_and_strided_views(cuda):
    """A view that is not contiguous, or not 16-byte aligned, is copied by the
    wrapper before the launch; the result is unchanged."""
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda) for a in _wkv_inputs(2, 9, 2, 32, 4))
    want = ops.wkv6(r, k, v, w, u, s0)
    big = torch.zeros(r.numel() + 1, device=cuda)
    big[1:] = r.reshape(-1)
    r_off = big[1:].view(r.shape)  # 4 bytes past an aligned start
    k_t = k.transpose(0, 1).contiguous().transpose(0, 1)  # strided
    got = ops.wkv6(r_off, k_t, v, w, u, s0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("scan_layers", [False, True])
def test_reduced_serve_on_card_matches_cpu(cuda, scan_layers):
    """The reduced model served on the card through kernel wkv6 against the
    same weights on the CPU (plain): equal greedy tokens, last hidden state
    and caches within the tolerance of the CPU parity tests."""
    cfg = _reduced(scan_layers=scan_layers)
    B, S, steps = 2, 24, 4
    shape = InputShape("t", S + steps, B, "decode")
    params = T.init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    results = []
    for device in ("cpu", cuda):
        sb = build_serve(cfg, shape, device)
        p = params if device == "cpu" else \
            interop.params_from_numpy(interop.params_to_numpy(params), cfg, device)
        ops.reset_launches()
        last, cache = sb.prefill_step(p, {"tokens": toks})
        tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
        out = []
        for _ in range(steps):
            tok, cache = sb.serve_step(p, cache, tok)
            out.append(tok.cpu())
        results.append((last.cpu(), {k: v.cpu() for k, v in flatten_with_paths(cache).items()},
                        torch.cat(out, 1), dict(ops.LAUNCHES)))
    (l0, c0, t0, n0), (l1, c1, t1, n1) = results
    assert n0["wkv6"] == 0 and n1["wkv6"] == cfg.n_layers * (1 + steps)
    assert torch.equal(t0, t1)
    _close(l1, l0.numpy(), "last hidden")
    for k in c0:
        _close(c1[k].to(torch.float32), c0[k].to(torch.float32).numpy(), k)
