"""The port's MoE layer and the MoE families' trainer against the JAX
package.

* ``moe_ffn`` directly against the reference's (under ``shard_map`` on a
  1 x 1 mesh), on the reduced qwen3-moe (4 experts, top-2) and
  deepseek-v2-lite (with its shared experts) layers at capacity factor 0.5
  (tokens dropped) and 4.0 (none dropped), and with an all-zero router
  (every probability ties, so ``lax.top_k``'s lower-index order decides
  the slots and so the drops): outputs rtol 1e-5, ``aux`` rtol 1e-6.  With
  the zero router an expert that got no token has exactly zero gradient.
* The W = 4 trainer: 3 steps of the reduced qwen3-moe and deepseek-v2-lite
  under ``qsgd_kernel`` EF on the int8 compressed wire, the ``router``
  leaves through their own rule (4 levels), against the reference's
  ``build_bundle`` on a ``data=4`` mesh in one subprocess, the noise hook
  replaying its key chain: losses rtol 1e-4, booked wire by tag and axes
  equal; ``eval_step(metrics=True)`` reports ``ce`` and ``aux``.
* The plain per-expert loop (``models/moe_ref.py``, the card's check of
  ``moe_ffn`` at full width) agrees with ``moe_ffn`` at rtol 1e-5.
* A reduced deepseek-v2-lite checkpoint (the ``prefix`` list, the ``moe``
  leaves) written by the reference restores in the port bitwise, and the
  reverse.
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
from jax.sharding import PartitionSpec as P

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.compat import shard_map
from repro.configs import get_config as jget
from repro.core.types import CommConfig as JCommConfig
from repro.data.pipeline import BigramSource as JBigram
from repro.launch.mesh import make_test_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.sharding import AxisCtx
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant as jconstant
from repro.train.steps import build_bundle as jbuild_bundle
from repro.train.trainer import Trainer as JTrainer
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import BigramSource
from repro_torch.models import layers as L
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedules import constant
from repro_torch.train.steps import build_bundle
from repro_torch.train.trainer import Trainer
from repro_torch.utils.tree import flatten_with_paths
from test_torch_ckpt import _flat, _jflat
from test_torch_sync import _noise, _one_thread  # noqa: F401

MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
W, STEPS, LR = 4, 3, 0.05
SHAPE = dict(seq_len=32, global_batch=8)


class _Data:
    def __init__(self, vocab, shape):
        self.src, self.shape = BigramSource(vocab, seed=0), shape

    def batch(self, step):
        return self.src.batch(step, self.shape.global_batch, self.shape.seq_len)


def _moe_layer(arch, zero_router=False):
    """(port cfg, reference cfg, the reference's first MoE layer's params
    as numpy, x (2, 32, d) f32 from a seed)."""
    jcfg = jget(arch).reduced()
    cfg = get_config(arch).reduced()
    params = JT.init_params(jcfg, jax.random.key(0), 1)
    p = {k: np.asarray(v) for k, v in jflatten(params["blocks"][0]["0"]["moe"]).items()}
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, p, x


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _reference_moe(jcfg, p, x, cf):
    mesh = make_test_mesh(1, 1)
    specs = jax.tree.map(lambda _: P(), p)
    fn = jax.jit(shard_map(lambda q, h: JL.moe_ffn(jcfg, q, h, AxisCtx(), capacity_factor=cf),
                           mesh=mesh, in_specs=(specs, P()), out_specs=(P(), P()),
                           check_vma=False))
    y, aux = fn(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return np.asarray(y), float(aux)


CASES = [(arch, cf, zero) for arch in MOE_ARCHS for cf in (0.5, 4.0) for zero in (False, True)]


@pytest.mark.parametrize("arch,cf,zero_router", CASES,
                         ids=[f"{a.split('-')[0]}-cf{cf}{'-tie' if z else ''}"
                              for a, cf, z in CASES])
def test_moe_ffn_matches_reference(arch, cf, zero_router):
    cfg, jcfg, p, x = _moe_layer(arch, zero_router)
    want_y, want_aux = _reference_moe(jcfg, _nest(p), x, cf)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    y, aux = L.moe_ffn(cfg, _nest(tp), torch.from_numpy(x), capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5 * np.abs(want_y).max())
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-6)
    assert any(k.startswith("shared/") for k in tp) == (arch == "deepseek-v2-lite-16b")
    # cf 0.5 drops tokens (half the buffer of an even split), cf 4.0 none
    T, k, E = 64, cfg.experts_per_token, cfg.n_experts
    C = L.moe_capacity(cfg, T, cf)
    assert (C * E < T * k) == (cf == 0.5) and C >= (T if cf == 4.0 else 0)


def test_zero_router_ties_take_the_lower_experts_and_starve_the_rest():
    """Every probability ties: each token routes to experts 0 and 1 (the
    lower indices, in that order), so experts 2 and 3 get no token and
    their gradients are exactly zero; at cf 0.5 experts 0 and 1 keep their
    first C tokens in flat T*k order."""
    cfg, _, p, x = _moe_layer("qwen3-moe-30b-a3b", zero_router=True)
    probs = torch.full((64, cfg.n_experts), 0.25)
    _, idx = L.router_top_k(probs, cfg.experts_per_token)
    assert idx.tolist() == [[0, 1]] * 64
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p.items()}
    y, _ = L.moe_ffn(cfg, _nest(tp), torch.from_numpy(x), capacity_factor=0.5)
    C = L.moe_capacity(cfg, 64, 0.5)
    g = torch.autograd.grad(y.square().sum(), [tp["wi"], tp["wg"], tp["wo"]])
    for gw in g:
        assert torch.count_nonzero(gw[2:]) == 0
        assert all(torch.count_nonzero(gw[e]) > 0 for e in (0, 1))
    # tokens past the first C of each expert contribute nothing
    y_all, _ = L.moe_ffn(cfg, _nest({k: v.detach() for k, v in tp.items()}),
                         torch.from_numpy(x), capacity_factor=4.0)
    yt, yat = y.detach().reshape(64, -1), y_all.reshape(64, -1)
    np.testing.assert_allclose(yt[:C].numpy(), yat[:C].numpy(), rtol=1e-6, atol=1e-7)
    assert torch.count_nonzero(yt[C:]) == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_plain_loop_matches_moe_ffn(arch, cf):
    """``models/moe_ref.py``'s per-expert loop, the card's check of
    ``moe_ffn`` at full width, agrees with it here (cf 2.0 = E / k: no
    drops), and counts each expert's kept tokens."""
    from repro_torch.models.moe_ref import moe_ffn_loop

    cfg, _, p, x = _moe_layer(arch)
    tp = _nest({k: torch.from_numpy(v.copy()) for k, v in p.items()})
    y, _ = L.moe_ffn(cfg, tp, torch.from_numpy(x), capacity_factor=cf)
    want, kept = moe_ffn_loop(tp, torch.from_numpy(x), k=cfg.experts_per_token,
                              capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    C, Tk = L.moe_capacity(cfg, 64, cf), 64 * cfg.experts_per_token
    assert int(kept.max()) <= C and (int(kept.sum()) < Tk) == (cf == 0.5)


# ---------------------------------------------------------------------------
# Checkpoints across the packages.
# ---------------------------------------------------------------------------

DS = "deepseek-v2-lite-16b"
BSP_EF = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
              wire_format="compressed", error_feedback=True)


def test_deepseek_checkpoint_crosses_the_packages(tmp_path):
    """The reduced deepseek-v2-lite (dense prefix layer, MLA, shared and
    routed experts) after 1 step at W = 1 with momentum 0.9: the
    reference's checkpoint restores in the port bitwise, the port's in the
    reference; the next step's loss agrees within rtol 1e-4."""
    jcfg, cfg = jget(DS).reduced(), get_config(DS).reduced()
    shape = InputShape("train", SHAPE["seq_len"], 4, "train")
    from repro.configs.base import InputShape as JInputShape

    jshape = JInputShape("train", SHAPE["seq_len"], 4, "train")
    jsrc = JBigram(jcfg.vocab, seed=0)

    class JData:
        def batch(self, step):
            return jsrc.batch(step, 4, SHAPE["seq_len"])

    jb = jbuild_bundle(jcfg, make_test_mesh(data=1, model=1), JCommConfig(**BSP_EF),
                       jopt.momentum_sgd(0.9), jshape, seed=0, cache=False)
    jt = JTrainer(jb, JData(), jconstant(0.01), log_every=1)
    jstate = jt.fit(jt.init(), 1)
    jsave(str(tmp_path / "ref"), jstate, step=1)

    bundle = build_bundle(cfg, CommConfig(**BSP_EF), opt.momentum_sgd(0.9), shape,
                          n_workers=1, seed=0, device="cpu", noise=_noise)
    tr = Trainer(bundle, _Data(cfg.vocab, shape), constant(0.01), log_every=1)
    state, step = tr.restore(str(tmp_path / "ref"))
    assert step == 1
    port_flat, ref_flat = _flat(bundle.checkpoint_tree(state)), _jflat(jstate)
    assert port_flat.keys() == ref_flat.keys()
    assert any(k.startswith("params/prefix/0/mlp/") for k in port_flat)
    assert any(k.endswith("moe/shared/wi") for k in port_flat)
    assert any(k.endswith("attn/w_dkv") for k in port_flat)
    for k in port_flat:
        np.testing.assert_array_equal(np.asarray(port_flat[k]), ref_flat[k], err_msg=k)

    # port -> reference, after one more step on each side
    state = tr.fit(state, 1, start_step=1)
    jstate = jt.fit(jstate, 1, start_step=1)
    assert tr.history[-1]["loss"] == pytest.approx(jt.history[-1]["loss"], rel=1e-4)
    tr.save(str(tmp_path / "port"), state, 2)
    back, step = jrestore(str(tmp_path / "port"), jt.init())
    assert step == 2
    port_flat, ref_flat = _flat(bundle.checkpoint_tree(state)), _jflat(back)
    assert port_flat.keys() == ref_flat.keys()
    for k in port_flat:
        np.testing.assert_array_equal(np.asarray(port_flat[k]), ref_flat[k], err_msg=k)
    assert flatten_with_paths(state["params"]).keys() == {
        k.split("/", 1)[1] for k in port_flat if k.startswith("params/")}


# ---------------------------------------------------------------------------
# The W = 4 trainer against the reference's bundle.
# ---------------------------------------------------------------------------

CELL = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
            wire_format="compressed", error_feedback=True,
            per_tensor_rules=[["router", "qsgd_kernel", {"levels": 4}]])

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
kw = cells.pop("comm")
kw["per_tensor_rules"] = [tuple(r) for r in kw["per_tensor_rules"]]


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


out = {}
for arch in cells["archs"]:
    cfg = get_config(arch).reduced()
    shape = InputShape("train", cells["seq_len"], cells["global_batch"], "train")
    jb = build_bundle(cfg, make_test_mesh(data=4, model=1), CommConfig(**kw),
                      momentum_sgd(0.0), shape, seed=0, cache=False)
    tr = Trainer(jb, Data(cfg.vocab, shape), constant(cells["lr"]), log_every=1)
    st = tr.init()
    with jcomms.capture() as log:
        st = tr.fit(st, 1)
    st = tr.fit(st, cells["steps"] - 1, start_step=1)
    out[arch] = {"loss": [h["loss"] for h in tr.history], "wire": by_tag_axes(log),
                 "rules": {b.name: [b.compressor_name, dict(b.compressor_kwargs)]
                           for b in jb.bucket_plan.buckets}}
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """The reference's series in a subprocess with W host devices, started
    before the module's tests so that it runs beside them."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={W}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    cells = dict(comm=CELL, archs=list(MOE_ARCHS), lr=LR, steps=STEPS, **SHAPE)
    proc = subprocess.Popen([sys.executable, "-c",
                             REFERENCE.replace("CELLS_JSON", json.dumps(cells))],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_series(_reference_run):
    out, err = _reference_run.communicate(timeout=600)
    assert _reference_run.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return json.loads(out.split("REF ", 1)[1])


def _by_tag_axes(log):
    out = {}
    for r in log.records:
        b = r.wire_bytes * r.mult
        if b:
            key = (r.tag or "untagged") + "|" + ",".join(r.axes)
            out[key] = out.get(key, 0.0) + b
    return out


def _reference_params(arch, cfg):
    jparams = JT.init_params(jget(arch).reduced(), jax.random.key(0), 1)
    return interop.params_from_numpy({k: np.asarray(v) for k, v in jflatten(jparams).items()},
                                     cfg, "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_trainer_series_matches_reference(arch, reference_series):
    cfg = get_config(arch).reduced()
    shape = InputShape("train", SHAPE["seq_len"], SHAPE["global_batch"], "train")
    comm = CommConfig(**{**CELL, "per_tensor_rules": [tuple(r) for r in CELL["per_tensor_rules"]]})
    bundle = build_bundle(cfg, comm, opt.momentum_sgd(0.0), shape, n_workers=W, seed=0,
                          device="cpu", noise=_noise)
    tr = Trainer(bundle, _Data(cfg.vocab, shape), constant(LR), log_every=1)
    state = tr.fit(bundle.init_state(_reference_params(arch, cfg)), STEPS)
    want = reference_series[arch]
    np.testing.assert_allclose([h["loss"] for h in tr.history], want["loss"], rtol=1e-4)
    assert all(h["aux"] > 0 for h in tr.history)
    # eval_step's metrics: the loss is ce + router_aux_coef * aux, worker means
    loss, m = bundle.eval_step(state, tr._put(tr.data.batch(STEPS)), metrics=True)
    assert float(m["aux"]) > 0
    assert float(loss) == pytest.approx(float(m["ce"] + cfg.router_aux_coef * m["aux"]),
                                        rel=1e-6)
    assert _by_tag_axes(bundle.logs["train"]) == pytest.approx(want["wire"], rel=1e-12)
    rules = {b.name: [b.compressor_name, dict(b.compressor_kwargs)]
             for b in bundle.bucket_plan.buckets}
    assert rules == want["rules"]
    routers = [n for n in rules if n.endswith("moe/router")]
    assert routers and all(rules[n][1] == {"levels": 4} for n in routers)
    assert sum(v[1] == {"levels": 16} for v in rules.values()) == len(rules) - len(routers)
