"""The attention families beyond qwen3-0.6b against the JAX package:
qwen3-moe-30b-a3b (128 experts, top-8), deepseek-v2-lite-16b (MLA, shared
and routed experts, a dense first layer), glm4-9b (partial RoPE),
qwen1.5-32b (qkv bias) and gemma3-12b (5 local : 1 global, window 1024).

* ``forward_loss`` and every leaf's gradient of each ``reduced()`` variant
  (f32; gemma3's reduced window is 16 < seq 64, so its sliding path runs),
  of qwen3-moe with ``scan_layers=True`` and of gemma3 with a logits
  softcap, against the reference's ``value_and_grad(forward_loss)`` under
  ``shard_map`` on a 1 x 1 mesh, from the reference's ``init_params(...,
  key(0), 1)`` through ``interop``: loss, ``ce`` and ``aux`` rtol 1e-5,
  gradients rtol 1e-4 / atol 1e-6 (as tests/test_torch_model.py).
* Each full config's parameter tree from the defs alone (nothing
  allocated): paths, shapes and the count equal to the reference's
  ``abstract_params(cfg, 1)``.
* ``launch/train.py --arch <each> --reduced --device cpu --steps 2`` runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as jget
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as JT
from repro.models.sharding import AxisCtx
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.utils.tree import flatten_with_paths
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "glm4-9b", "qwen1.5-32b", "gemma3-12b")
#: (arch, config updates on top of reduced())
CASES = [(a, {}) for a in ARCHS] + [("qwen3-moe-30b-a3b", {"scan_layers": True}),
                                     ("gemma3-12b", {"logits_softcap": 30.0})]


def _reference(jcfg, jparams, batch):
    """The reference's loss, metrics and gradients on a 1 x 1 mesh."""
    _, specs, _ = JT.abstract_params(jcfg, 1)

    def f(p, b):
        (loss, m), g = jax.value_and_grad(
            lambda q: JT.forward_loss(jcfg, q, b, AxisCtx()), has_aux=True)(p)
        return loss, m, g

    bspec = {"tokens": P("data", None), "labels": P("data", None)}
    fn = jax.jit(shard_map(f, mesh=make_test_mesh(1, 1), in_specs=(specs, bspec),
                           out_specs=(P(), P(), specs), check_vma=False))
    loss, m, g = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in m.items()},
            {k: np.asarray(v) for k, v in jflatten(g).items()})


@pytest.mark.parametrize("arch,upd", CASES,
                         ids=[a + "".join(f"-{k}" for k in u) for a, u in CASES])
def test_forward_loss_and_grads_match_reference(arch, upd):
    jcfg = jget(arch).reduced().with_updates(**upd)
    cfg = get_config(arch).reduced().with_updates(**upd)
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
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), want_m[k], rtol=1e-5, err_msg=k)
    assert (want_m["aux"] > 0) == cfg.moe
    assert list(tparams) == list(want_grads)
    for path, g in zip(tparams, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[path], rtol=1e-4, atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_tree_matches_reference(arch):
    jabs, _, _ = JT.abstract_params(jget(arch), 1)
    want = {k: tuple(v.shape) for k, v in jflatten(jabs).items()}
    got = {k: tuple(d.shape) for k, d in flatten_with_paths(T.param_defs(get_config(arch))).items()}
    assert list(got) == list(want)
    assert got == want
    count = sum(int(np.prod(s)) for s in got.values())
    assert count == sum(int(np.prod(s)) for s in want.values()) > 8e9


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_each_family(arch, capsys):
    assert launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                              "--workers", "2", "--seq-len", "16", "--global-batch", "4",
                              "--warmup", "1", "--comm", "qsgd"]) == 0
    out = capsys.readouterr().out
    assert "step     1 loss" in out
    aux = [float(line.split(" aux ")[1].split()[0]) for line in out.splitlines()
           if line.startswith("step ")]
    assert len(aux) == 2 and (min(aux) > 0) == get_config(arch).moe
