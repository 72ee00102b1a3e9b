"""The model axis against the reference's ``shard_map``: ``forward_loss``
and every leaf's gradient at model-axis size 2, for qwen3-0.6b,
deepseek-v2-lite-16b (MLA, shared and routed experts), qwen3-moe-30b-a3b
and rwkv6-3b here, and (test_torch_model_axis_ref2.py) hymba-1.5b with 5
heads (they pad to 6), qwen2-vl-2b (patches, M-RoPE) and
seamless-m4t-large-v2 (the encoder, cross-attention), each ``reduced()``
(f32), against the reference's ``value_and_grad`` under
``shard_map`` on a 1 x 2 (data x model) mesh with its ``_fix_model_grads``
fix-up, gathered to the global layout, in one 2-device subprocess for the
module.  Both start from the reference's ``init_params(cfg, key(0), 2)``
carried in by ``interop.params_from_numpy(..., msize=2)``.  The loss is
the reference's reported value, ce + coef * aux / 2, within rtol 1e-5,
``ce`` and ``aux`` too; gradients within rtol 1e-4 / atol 1e-6 x the
leaf's largest magnitude (rwkv6-3b: 1e-3 x, the plain scan's f32 backward
over 32 steps differs between the packages by ~1e-4 x max already at
model-axis size 1, in ``u``'s gradient, with the summation order).  The booked tensor-parallel records of the
forward (by kind, axes, payload bytes and tag) equal the reference's
capture, and the reference's ``tp_grad_fixup`` records are one psum of
each replicated leaf's gradient, as the port's step books them.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import comms
from repro_torch.models import transformer as T
from repro_torch.utils.tree import flatten_with_paths
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

M = 2
ARCHS = {"qwen3-0.6b": {}, "deepseek-v2-lite-16b": {}, "qwen3-moe-30b-a3b": {},
         "rwkv6-3b": {}}

REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_config
from repro.core import comms
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as T
from repro.models.sharding import AxisCtx
from repro.train.steps import _fix_model_grads
from repro.utils.tree import flatten_with_paths
ARCHS, OUT = json.loads(sys.argv[1]), sys.argv[2]
out = {}
for arch, upd in ARCHS.items():
    cfg = get_config(arch).reduced().with_updates(**upd)
    _, specs, _ = T.abstract_params(cfg, 2)
    params = T.init_params(cfg, jax.random.key(0), 2)
    batch = dict(np.load(f"{OUT}/{arch}.batch.npz"))
    bspec = {k: P("data") for k in batch}

    def f(p, b):
        (loss, m), g = jax.value_and_grad(
            lambda q: T.forward_loss(cfg, q, b, AxisCtx()), has_aux=True)(p)
        return loss, m, _fix_model_grads(g, specs, "model")

    fn = shard_map(f, mesh=make_test_mesh(1, 2), in_specs=(specs, bspec),
                   out_specs=(P(), P(), specs), check_vma=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with comms.capture() as log:
        jax.eval_shape(fn, params, jb)
    loss, m, g = jax.jit(fn)(params, jb)
    np.savez(f"{OUT}/{arch}.params.npz",
             **{k: np.asarray(v, np.float32) for k, v in flatten_with_paths(params).items()})
    np.savez(f"{OUT}/{arch}.grads.npz",
             **{k: np.asarray(v, np.float32) for k, v in flatten_with_paths(g).items()})
    recs = sorted((r.kind, list(r.axes), r.payload_bytes * r.mult, r.tag)
                  for r in log.records if "model" in r.axes)
    out[arch] = {"loss": float(loss), "ce": float(m["ce"]), "aux": float(m["aux"]),
                 "records": recs}
print("REF " + json.dumps(out))
"""


def _batch(cfg) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    out = {k: rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32) for k in ("tokens", "labels")}
    if cfg.modality == "vision":
        out["patches"] = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    return out


def run_reference(archs: dict, out) -> dict:
    """The reference's loss, metrics, global gradients and booked records of
    each arch at model-axis size 2, from one 2-device subprocess; params and
    gradients land in ``out``."""
    for arch, upd in archs.items():
        np.savez(out / f"{arch}.batch.npz", **_batch(get_config(arch).reduced()
                                                     .with_updates(**upd)))
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(archs), str(out)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return json.loads(run.stdout.split("REF ", 1)[1])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("model_axis_ref")
    return out, run_reference(ARCHS, out)


def check_against_reference(arch: str, upd: dict, out, want: dict) -> None:
    cfg = get_config(arch).reduced().with_updates(**upd)
    params = interop.params_from_numpy(dict(np.load(out / f"{arch}.params.npz")), cfg, "cpu", M)
    want_grads = dict(np.load(out / f"{arch}.grads.npz"))
    batch = {k: torch.from_numpy(v) for k, v in np.load(out / f"{arch}.batch.npz").items()}
    tparams = flatten_with_paths(params)
    for v in tparams.values():
        v.requires_grad_(True)
    with comms.capture() as log:
        loss, m = T.forward_loss(cfg, params, batch, msize=M, use_kernel=False)
    grads = torch.autograd.grad(loss, list(tparams.values()))
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert set(tparams) == set(want_grads)
    scale = 1e-3 if cfg.family == "ssm" else 1e-6
    for path, g in zip(tparams, grads):
        w = want_grads[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=scale * max(1.0, float(np.abs(w).max())), err_msg=path)
    got = sorted((r.kind, list(r.axes), r.payload_bytes * r.mult, r.tag) for r in log.records)
    recs = [tuple(r) for r in want["records"]]
    assert got == [r for r in recs if r[3] != "tp_grad_fixup"]
    # the fix-up: one psum of each replicated leaf's gradient
    defs = flatten_with_paths(T.param_defs(cfg, M))
    fix = sorted(("psum", ["model"], float(g.numel() * g.element_size()), "tp_grad_fixup")
                 for g, d in zip(grads, defs.values()) if d.shard is None)
    assert fix == [r for r in recs if r[3] == "tp_grad_fixup"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_loss_and_grads_match_shard_map(arch, reference):
    out, ref = reference
    check_against_reference(arch, ARCHS[arch], out, ref[arch])
