"""Training RWKV6 in the port against the JAX package.

* ``ref.wkv6_backward`` (kernel ``wkv6_bwd``'s plain version) against
  ``jax.vjp`` of the reference's ``wkv_scan`` and against autograd through
  ``ref.wkv6``: w holding 0, 1 and 1e-3, ragged S, S = 1, nonzero s0 and
  dsT (and dsT absent): each gradient within rtol 1e-4 / atol 1e-5 x its
  largest magnitude (f32; the sums run in other orders).
* ``ops.WKV6Function``, the route ``ops.wkv6`` takes on the card under
  autograd, driven on the CPU with its launches swapped for the plain
  versions: every leaf of ``rwkv_block`` (wr, wk, wv, w0, wd_A, wd_B, u and
  the ddlerp weights) gets the plain path's gradient; a bare kernel launch
  under autograd is refused.
* ``forward_loss`` and every leaf's gradient of the reduced rwkv6-3b (f32,
  list and stacked layouts, ``remat="full"``) against the reference's
  ``value_and_grad`` on a 1 x 1 mesh: loss rtol 1e-5, gradients rtol 1e-4
  / atol 1e-6 (as tests/test_torch_families.py), the atol widened to 1e-5
  x the leaf's largest magnitude where that is larger (as
  tests/test_torch_rwkv.py holds the blocks): ``u``'s gradient sums r k (v
  . dy) over every token, and an element that cancels to near zero keeps
  the f32 rounding of its ~1-sized terms, ~1e-6.
* The W = 4 trainer: 3 steps under ``threshold`` EF (kernel ``threshold``)
  against the reference's ``build_bundle`` on a ``data=4`` mesh in one
  subprocess, the noise hook replaying its key chain: losses rtol 1e-4,
  booked wire by tag and axes equal.
* ``launch/train.py --arch rwkv6-3b --reduced --device cpu`` runs.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import rwkv as JRW
from repro.models import transformer as JT
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import flatten_with_paths
from test_torch_families import _reference
from test_torch_moe import _by_tag_axes, _Data
from test_torch_sync import _noise, _one_thread  # noqa: F401

NAMES = ("r", "k", "v", "w", "u", "s0")


def _inputs(B, S, H, hd, seed, edge=True):
    """r, k, v, w (B, S, H, hd), u (H, hd), s0, dsT (B, H, hd, hd), dy (B, S, H,
    hd) as f32 numpy; ``edge`` plants w = 0, 1 and 1e-3."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, hd)))) * 0.5 + 0.4).astype(np.float32)
    if edge:
        w[:, ::7, :, ::3] = 0.0
        w[:, 1::5, :, 1::3] = 1.0
        w[:, 2::3, :, 2::3] = 1e-3
    u = rng.standard_normal((H, hd)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    dy = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dsT = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    return (r, k, v, w, u, s0), dy, dsT


def _assert_grads(got, want, what):
    for name, g, wv in zip(NAMES, got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(g.detach().numpy(), wv, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(wv).max()), err_msg=f"{what} d{name}")


@pytest.mark.parametrize("B,S,H,hd,with_dsT", [
    (2, 37, 2, 16, True), (1, 8, 3, 32, True), (2, 1, 2, 16, True), (1, 24, 2, 16, False)])
def test_wkv6_backward_matches_reference_vjp(B, S, H, hd, with_dsT):
    ins, dy, dsT = _inputs(B, S, H, hd, seed=S + hd)
    _, vjp = jax.vjp(JRW.wkv_scan, *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dsT if with_dsT else np.zeros_like(dsT))))
    tins = [torch.from_numpy(a) for a in ins]
    got = ref.wkv6_backward(*tins, torch.from_numpy(dy),
                            torch.from_numpy(dsT) if with_dsT else None)
    assert all(g.dtype == torch.float32 for g in got)
    assert got[4].shape == (H, hd) and got[5].shape == (B, H, hd, hd)
    _assert_grads(got, want, "against jax.vjp(wkv_scan)")
    # and against autograd through the plain forward
    leaves = [t.clone().requires_grad_(True) for t in tins]
    y, sT = ref.wkv6(*leaves)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_dsT:
        loss = loss + (sT * torch.from_numpy(dsT)).sum()
    _assert_grads(got, torch.autograd.grad(loss, leaves), "against autograd of ref.wkv6")
    # the wrapper on CPU tensors is the plain version
    for a, b in zip(ops.wkv6_backward(*tins, torch.from_numpy(dy),
                                      torch.from_numpy(dsT) if with_dsT else None), got):
        assert torch.equal(a, b)


@pytest.fixture
def plain_route(monkeypatch):
    """``ops.wkv6``'s card route on CPU tensors: WKV6Function, its launches
    replaced by the plain versions (counted as they would be)."""
    def launch(r, k, v, w, u, s0, *, chunked):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, s0)):
            raise AssertionError("a launch recorded by autograd")
        ops.LAUNCHES["wkv6"] += 1
        return ref.wkv6(r, k, v, w, u, s0)

    def backward(*args):  # the card's two launches, wkv6_bwd_states and wkv6_bwd
        ops.LAUNCHES["wkv6_bwd_states"] += 1
        ops.LAUNCHES["wkv6_bwd"] += 1
        return ref.wkv6_backward(*args)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_wkv6_launch", launch)
    monkeypatch.setattr(ops, "wkv6_backward", backward)
    ops.reset_launches()
    yield
    ops.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_route_gives_every_leaf_its_gradient(plain_route, dtype):
    cfg = get_config("rwkv6-3b").reduced().with_updates(param_dtype=str(dtype)[6:],
                                                        compute_dtype=str(dtype)[6:])
    params = T.init_params(cfg, seed=3, device="cpu")
    p = params["blocks"][0]["0"]
    gen = torch.Generator().manual_seed(4)
    for name in ("w0", "mu", "mu_base"):  # trained-like decays and mixes
        p[name] = (torch.randn(p[name].shape, generator=gen) * 0.3).to(dtype)
    names = ("wr", "wk", "wv", "wg", "w0", "wd_A", "wd_B", "u", "mu_base", "mu", "mix_A", "mix_B")
    x = torch.randn(2, 9, cfg.d_model, generator=gen).to(dtype)
    grads = {}
    for use_kernel in (True, False):
        leaves = {n: p[n].detach().clone().requires_grad_(True) for n in names}
        out, _ = RW.rwkv_block(cfg, {**p, **leaves}, x, use_kernel=use_kernel)
        assert _reaches(out.grad_fn, "WKV6FunctionBackward") == use_kernel
        g = torch.autograd.grad((out.float() * out.float()).sum(), list(leaves.values()))
        grads[use_kernel] = dict(zip(names, g))
    assert ops.LAUNCHES == {**{k: 0 for k in ops.LAUNCHES}, "wkv6": 1, "wkv6_bwd_states": 1,
                            "wkv6_bwd": 1}, ops.LAUNCHES
    for n in names:
        got, want = grads[True][n], grads[False][n]
        assert got.dtype == p[n].dtype and bool(torch.count_nonzero(want)), n
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=tol,
                                   atol=tol * float(want.abs().max()), err_msg=n)


def _reaches(fn, name, seen=None):
    """Whether autograd node ``fn`` leads to a node of class ``name``."""
    seen = set() if seen is None else seen
    if fn is None or fn in seen:
        return False
    seen.add(fn)
    return type(fn).__name__ == name or any(_reaches(f, name, seen) for f, _ in fn.next_functions)


def test_a_launch_under_autograd_is_refused():
    ins, _, _ = _inputs(1, 4, 2, 16, seed=1)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in ins)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        ops._wkv6_launch(r.requires_grad_(True), k, v, w, u, s0, chunked=False)


def test_wkv6_function_in_a_training_loss(plain_route):
    """forward_loss of the reduced rwkv6-3b through the card route (remat
    recomputes each block: 2 forward launches a layer, and the backward's
    wkv6_bwd_states and wkv6_bwd) gives the plain path's loss and
    gradients."""
    cfg = get_config("rwkv6-3b").reduced()
    params = T.init_params(cfg, seed=5, device="cpu")
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    out = {}
    for use_kernel in (True, False):
        leaves = flatten_with_paths(params)
        for t in leaves.values():
            t.requires_grad_(True)
        loss, _ = T.forward_loss(cfg, params, batch, use_kernel=use_kernel)
        out[use_kernel] = (loss.detach(), torch.autograd.grad(loss, list(leaves.values())))
    assert ops.LAUNCHES == {**{k: 0 for k in ops.LAUNCHES}, "wkv6": 2 * cfg.n_layers,
                            "wkv6_bwd_states": cfg.n_layers, "wkv6_bwd": cfg.n_layers}
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_forward_loss_and_grads_match_reference(scan_layers):
    jcfg = jget("rwkv6-3b").reduced().with_updates(scan_layers=scan_layers)
    cfg = get_config("rwkv6-3b").reduced().with_updates(scan_layers=scan_layers)
    assert cfg.remat == "full"
    jparams = JT.init_params(jcfg, jax.random.key(0), 1)
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
    assert float(m["aux"]) == want_m["aux"] == 0.0
    assert list(tparams) == list(want_grads)
    for path, g in zip(tparams, grads):
        want = want_grads[path]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=max(1e-6, 1e-5 * float(np.abs(want).max())),
                                   err_msg=path)


# ---------------------------------------------------------------------------
# The W = 4 trainer against the reference's bundle.
# ---------------------------------------------------------------------------

W, STEPS, LR = 4, 3, 0.05
SHAPE = dict(seq_len=32, global_batch=8)
#: threshold (kernel ``threshold``) with error feedback: its mask is decided
#: by |x| >= tau, far from most elements; a dithered quantizer (qsgd_kernel)
#: flips a level wherever the two packages' f32 gradients part by a rounding
#: step, and the EF trajectories then drift apart by ~3e-4 in 3 steps
CELL = dict(compressor="threshold", compressor_kwargs={"tau": 1e-3}, error_feedback=True)

REFERENCE = r"""
import json
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core import comms as jcomms
from repro.core.types import CommConfig
from repro.data.pipeline import BigramSource
from repro.launch.mesh import make_test_mesh
from repro.optim.optimizers import momentum_sgd
from repro.optim.schedules import constant
from repro.train.steps import build_bundle
from repro.train.trainer import Trainer
cells = json.loads('CELLS_JSON')


def by_tag_axes(log):
    out = {}
    for r in log.records:
        b = r.wire_bytes * r.mult
        if b:
            key = (r.tag or "untagged") + "|" + ",".join(r.axes)
            out[key] = out.get(key, 0.0) + b
    return out


class Data:
    def __init__(self, vocab, shape):
        self.src, self.shape = BigramSource(vocab, seed=0), shape

    def batch(self, step):
        return self.src.batch(step, self.shape.global_batch, self.shape.seq_len)


cfg = get_config("rwkv6-3b").reduced()
shape = InputShape("train", cells["seq_len"], cells["global_batch"], "train")
jb = build_bundle(cfg, make_test_mesh(data=4, model=1), CommConfig(**cells["comm"]),
                  momentum_sgd(0.0), shape, seed=0, cache=False)
tr = Trainer(jb, Data(cfg.vocab, shape), constant(cells["lr"]), log_every=1)
st = tr.init()
with jcomms.capture() as log:
    st = tr.fit(st, 1)
st = tr.fit(st, cells["steps"] - 1, start_step=1)
print("REF " + json.dumps({"loss": [h["loss"] for h in tr.history], "wire": by_tag_axes(log)}))
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """The reference's series in a subprocess with W host devices, started
    before the module's tests so that it runs beside them."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    cells = dict(comm=CELL, lr=LR, steps=STEPS, **SHAPE)
    proc = subprocess.Popen([sys.executable, "-c",
                             REFERENCE.replace("CELLS_JSON", json.dumps(cells))],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_trainer_series_matches_reference(_reference_run):
    cfg = get_config("rwkv6-3b").reduced()
    shape = InputShape("train", SHAPE["seq_len"], SHAPE["global_batch"], "train")
    bundle = build_bundle(cfg, CommConfig(**CELL), opt.momentum_sgd(0.0), shape, n_workers=W,
                          seed=0, device="cpu", noise=_noise)
    tr = Trainer(bundle, _Data(cfg.vocab, shape), constant(LR), log_every=1)
    jparams = JT.init_params(jget("rwkv6-3b").reduced(), jax.random.key(0), 1)
    params = interop.params_from_numpy({k: np.asarray(v) for k, v in jflatten(jparams).items()},
                                       cfg, "cpu")
    tr.fit(bundle.init_state(params), STEPS)
    out, err = _reference_run.communicate(timeout=900)
    assert _reference_run.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    want = json.loads(out.split("REF ", 1)[1])
    np.testing.assert_allclose([h["loss"] for h in tr.history], want["loss"], rtol=1e-4)
    assert _by_tag_axes(bundle.logs["train"]) == pytest.approx(want["wire"], rel=1e-12)


def test_train_launcher_runs_rwkv(capsys):
    assert launch_train.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu", "--steps",
                              "2", "--workers", "2", "--seq-len", "16", "--global-batch", "4",
                              "--warmup", "1", "--comm", "qsgd"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split(" loss ")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
