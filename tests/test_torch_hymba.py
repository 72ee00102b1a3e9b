"""The hybrid family (hymba-1.5b: GQA attention and Mamba heads side by side
in every layer) in the port against the JAX package.

* ``ssm._causal_conv``, the chunked and the sequential ``selective_scan``
  and ``ssm_block`` (from zero state, then carrying its conv and SSM state
  into a second call) against the reference's ``repro.models.ssm`` (the
  block under ``shard_map`` on a 1 x 1 mesh); the chunked scan at a ragged
  S, at chunk 16, 8 and 5, and at decays strong enough that exp(c_t) and
  most pairwise terms underflow, where its gradient must equal the
  sequential form's (finite: the s > t terms are masked before the exp).
* ``forward_loss`` and every leaf's gradient of the reduced hymba (f32,
  list and stacked layouts, the stacked one on the list's weights; window
  16 < seq 64, so the local layer's window bites) against the reference's
  ``value_and_grad`` on a 1 x 1 mesh: loss rtol 1e-5, gradients rtol 1e-4
  / atol 1e-6.
* Prefill and 6 greedy decode steps through both packages' ``build_serve``
  (tests/test_torch_serve.py's harness: caches, the SSM and conv states
  among them, within rtol 1e-5 / atol 1e-5 x max, tokens equal), in both
  layouts; the decode-equivalence identity within 1e-4 of max|logits|;
  ``serve_step`` (rings and SSM states written in place) equal to
  ``decode_step`` bitwise, which leaves its input cache alone.
* The full-width tree from the defs against ``abstract_params(hymba, 1)``.
* ``launch/train.py`` and ``launch/serve.py`` at ``--arch hymba-1.5b
  --reduced --device cpu``.

Tolerances: f32 on the CPU; the frameworks sum products in other orders,
and the chunked scan forms exp(c_t - c_s) where the reference multiplies
exp(dt A) step by step: scan outputs rtol 1e-4 / atol 1e-5 x max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import ssm as JSM
from repro.models import transformer as JT
from repro.models.sharding import AxisCtx
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as T
from repro_torch.train.steps import build_serve
from repro_torch.utils.tree import flatten_with_paths, tree_map
from test_torch_families import _reference
from test_torch_rwkv import _run_jax
from test_torch_serve import serve_matches_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ARCH = "hymba-1.5b"


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()), err_msg=what)


def _scan_inputs(B, S, di, st, seed, strong=False):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)  # softplus > 0
    A_log = rng.uniform(0.0, 3.0 if strong else 1.0, (di, st)).astype(np.float32)
    if strong:
        dt = dt * 2.0
    A = -np.exp(A_log)
    Bm, Cm = (rng.standard_normal((B, S, st)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, di, st)).astype(np.float32) * 0.5
    return u, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("kc", [3, 4])
def test_causal_conv_matches_reference(kc):
    rng = np.random.default_rng(kc)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((kc, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    state = rng.standard_normal((2, kc - 1, 24)).astype(np.float32)
    want, want_state = JSM._causal_conv(*(jnp.asarray(a) for a in (x, w, b, state)))
    got, got_state = SM._causal_conv(*(torch.from_numpy(a) for a in (x, w, b, state)))
    _close(got, want, "conv out", rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


@pytest.mark.parametrize("S,chunk", [(37, 16), (32, 8), (13, 5), (1, 16)])
def test_selective_scan_matches_reference(S, chunk):
    ins = _scan_inputs(2, S, 24, 16, seed=S)
    want_y, want_h = JSM.selective_scan(*(jnp.asarray(a) for a in ins))
    tins = [torch.from_numpy(a) for a in ins]
    for name, (y, h) in (("chunked", SM.selective_scan(*tins, chunk=chunk)),
                         ("sequential", SM.selective_scan_seq(*tins))):
        assert y.shape == (2, S, 24) and h.shape == (2, 24, 16)
        _close(y, want_y, f"{name} y")
        _close(h, want_h, f"{name} h")


def test_chunked_scan_gradient_under_strong_decay():
    """A_log up to 3 and dt doubled: per-step decays reach exp(-110), so
    exp(c_t) and most pairwise terms underflow and the unmasked s > t
    exponents (past 88) would overflow; the chunked form's gradient is
    finite and equals the sequential form's within rtol 1e-4 / atol 1e-4 x
    max (c_t - c_s is a difference of cumsums that reach ~1e3 here, so it
    carries their f32 rounding, ~1e-5 of dA's largest entry)."""
    ins = _scan_inputs(2, 40, 8, 16, seed=7, strong=True)
    grads = []
    for fn in (SM.selective_scan, SM.selective_scan_seq):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
        y, h = fn(*leaves)
        grads.append(torch.autograd.grad((y * y).sum() + (h * h).sum(), leaves))
    for name, g, want in zip(("u", "dt", "A", "Bm", "Cm", "h0"), *grads):
        assert bool(torch.isfinite(g).all()), name
        _close(g, want.numpy(), f"d{name}", atol=1e-4)


@pytest.mark.parametrize("carried", [False, True])
def test_ssm_block_matches_reference(carried):
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = JT.init_params(jcfg, jax.random.key(0), 1)
    jp = jparams["blocks"][0]["0"]["ssm"]
    params = interop.params_from_numpy({k: np.asarray(v) for k, v in jflatten(jparams).items()},
                                       cfg, "cpu")
    p = params["blocks"][0]["0"]["ssm"]
    rng = np.random.default_rng(4)
    # trained-like decays and biases, so the scan's data-dependent paths matter
    for name, a in (("A_log", rng.uniform(0.0, 2.0, p["A_log"].shape)),
                    ("dt_bias", rng.standard_normal(p["dt_bias"].shape)),
                    ("conv_b", rng.standard_normal(p["conv_b"].shape) * 0.1)):
        a = a.astype(np.float32)
        jp, p = {**jp, name: jnp.asarray(a)}, {**p, name: torch.from_numpy(a)}
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    ax = AxisCtx()
    splits = ((0, 13), (13, 21)) if carried else ((0, 21),)
    jstate = state = None
    for lo, hi in splits:
        want, jstate = _run_jax(lambda pp, xx, st: JSM.ssm_block(jcfg, pp, xx, ax, st),
                                jp, jnp.asarray(x[:, lo:hi]), jstate)
        got, state = SM.ssm_block(cfg, p, torch.from_numpy(x[:, lo:hi]), state)
        _close(got, want, f"ssm out [{lo}, {hi})")
        _close(state["h"], jstate["h"], f"ssm h after {hi}")
        _close(state["conv"], jstate["conv"], f"conv state after {hi}", rtol=1e-5)
        jstate = {k: jnp.asarray(v) for k, v in jstate.items()}
    assert state["h"].dtype == torch.float32 and state["conv"].shape == (2, 2, 512)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_forward_loss_and_grads_match_reference(scan_layers):
    """The stacked layout takes the list layout's weights, stacked: drawn
    in the stacked tree, a leaf gets std 1/sqrt(repeats) (the reference's
    fan-in rule; 1 at the reduced depth), and those ill-conditioned weights
    amplify the frameworks' f32 rounding to ~4e-4 of a gradient's largest
    entry (the stacked layout's conditioning, ROADMAP queue 3)."""
    jcfg = jget(ARCH).reduced().with_updates(scan_layers=scan_layers)
    cfg = get_config(ARCH).reduced().with_updates(scan_layers=scan_layers)
    assert cfg.layer_window("local", 64) == 16 and cfg.remat == "full"
    jparams = JT.init_params(jcfg.with_updates(scan_layers=False), jax.random.key(0), 1)
    if scan_layers:
        jparams = {**jparams, "blocks": jax.tree.map(lambda *xs: jnp.stack(xs),
                                                     *jparams["blocks"])}
    params = interop.params_from_numpy({k: np.asarray(v) for k, v in jflatten(jparams).items()},
                                       cfg, "cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    want_loss, want_m, want_grads = _reference(jcfg, jparams, batch)
    tparams = flatten_with_paths(params)
    for v in tparams.values():
        v.requires_grad_(True)
    loss, m = T.forward_loss(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tparams.values()))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"].detach()), want_m["ce"], rtol=1e-5)
    assert list(tparams) == list(want_grads)
    assert sum("/ssm/" in k for k in tparams) == 10 * cfg.n_layers
    for path, g in zip(tparams, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[path], rtol=1e-4, atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_prefill_and_decode_match_reference(scan_layers):
    serve_matches_reference(ARCH, scan_layers)


S, B, STEPS = 24, 2, 6


def test_decode_matches_full_forward():
    cfg = get_config(ARCH).reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1))
                            .astype(np.int32))
    with torch.no_grad():
        _, cache = T.prefill(cfg, params, {"tokens": toks[:, :S]}, max_seq=S + 1)
        got, _ = T.decode_logits(cfg, params, cache, toks[:, S:], max_seq=S + 1)
        h, _ = T.forward_hidden(cfg, params, toks)
        want = L.logits_local(params["embed"], h[:, -1:], softcap=cfg.logits_softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    assert torch.equal(torch.argmax(got, -1), torch.argmax(want, -1))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_serve_step_is_decode_step(scan_layers):
    """``serve_step`` writes the ring slots and the new SSM and conv states
    into the cache it is given; over STEPS steps its tokens and caches
    equal ``decode_step``'s bitwise, and ``decode_step`` leaves its input
    cache as it was."""
    cfg = get_config(ARCH).reduced().with_updates(scan_layers=scan_layers)
    params = T.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (B, S))
                            .astype(np.int32))
    sb = build_serve(cfg, InputShape("t", S + STEPS, B, "decode"), "cpu")
    _, cache = sb.prefill_step(params, {"tokens": toks})
    assert {k.rsplit("/", 1)[1] for k in flatten_with_paths(cache) if "/ssm/" in k} == \
        {"conv", "h"}
    want, want_tok, tok = cache, toks[:, :1], toks[:, :1]
    cache = tree_map(torch.clone, cache)
    for t in range(STEPS):
        before = {k: v.clone() for k, v in flatten_with_paths(want).items()}
        with torch.no_grad():
            want_tok, new = T.decode_step(cfg, params, want, want_tok, max_seq=S + STEPS)
        for k, v in flatten_with_paths(want).items():
            assert torch.equal(v, before[k]), (t, k)
        want = new
        tok, cache = sb.serve_step(params, cache, tok)
        assert torch.equal(tok, want_tok), t
        for (k, v), w in zip(flatten_with_paths(cache).items(),
                             flatten_with_paths(want).values()):
            assert torch.equal(v, w), (t, k)


def test_full_width_param_tree_matches_reference():
    jabs, _, _ = JT.abstract_params(jget(ARCH), 1)
    want = {k: tuple(v.shape) for k, v in jflatten(jabs).items()}
    got = {k: tuple(d.shape) for k, d in flatten_with_paths(T.param_defs(get_config(ARCH))).items()}
    assert list(got) == list(want)
    assert got == want
    assert got["blocks/0/ssm/in_x"] == (2, 1600, 3200)  # stacked over the 2 repeats
    count = sum(int(np.prod(s)) for s in got.values())
    assert count == sum(int(np.prod(s)) for s in want.values()) > 1.5e9


def test_train_launcher_runs_hymba(capsys):
    assert launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                              "--workers", "2", "--seq-len", "16", "--global-batch", "4",
                              "--warmup", "1", "--comm", "qsgd"]) == 0
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in capsys.readouterr().out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_serve_launcher_runs_hymba(capsys):
    assert launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len",
                              "20", "--batch", "2", "--decode", "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 20x2: ")
    sample = eval(lines[2].removeprefix("sample: "))  # noqa: S307 (a printed list of ints)
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)
