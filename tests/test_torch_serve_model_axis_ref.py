"""Serving on the model axis against the reference's ``build_serve`` on a
1 x 2 (data x model) mesh: qwen3-0.6b, glm4-9b, qwen1.5-32b and gemma3-12b
(a window of 16 that bites a prompt of 24) here; the MoE, MLA and RWKV6
families in ``_ref2.py``; hymba-1.5b, qwen2-vl-2b and seamless-m4t-large-v2
in ``_ref3.py``.  Each ``reduced()`` (f32) from the reference's
``init_params(cfg, key(0), 2)``, carried in by
``interop.params_from_numpy(..., msize=2)``, through the port's
``build_serve(..., msize=2)``, the reference's in one 2-device subprocess
per module:

* the prefill's last hidden state and every cache leaf (the global layout,
  the reference's sequence-sharded rings gathered), then 4 greedy steps
  from the reference's prefill cache: the tokens equal at each step and
  every cache leaf after each, all within rtol 1e-5 / atol 1e-6 x the
  leaf's largest magnitude, ``pos`` exact (rwkv6-3b: rtol 1e-4 / atol
  1e-5 x, test_torch_rwkv.py's bounds at model-axis size 1, where the two
  packages' f32 recurrences already part by 4.1e-6 x max|last hidden| on
  this prompt; at size 2, 2.5e-6 x);
* the booked model-axis records of the prefill and of one decode step,
  sorted (kind, axes, bytes x multiplicity, tag), equal to the
  reference's ``comms.capture``;
* (this module) ``_distributed_argmax`` bitwise against the reference's
  under ``shard_map`` at 2 and 4 shards on crafted logits: a cross-shard
  tie below 8 (the lower shard wins), a tie at 20.0 (2e7 - 1 rounds back
  to 2e7 in f32: both shards win, the token is the sum of their indices),
  a tie inside one shard (its first index), and random logits.
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
from repro_torch.configs.base import InputShape
from repro_torch.core import comms
from repro_torch.data.pipeline import SyntheticBatches
from repro_torch.models import transformer as T
from repro_torch.train.steps import build_serve
from repro_torch.utils.tree import flatten_with_paths
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

M = 2
#: prompt (patches included), batch and greedy steps
S, B, STEPS = 24, 2, 4
RTOL, ATOL = 1e-5, 1e-6
#: RWKV6's bounds at model-axis size 1 (test_torch_rwkv.py)
RWKV_RTOL, RWKV_ATOL = 1e-4, 1e-5
ARCHS = {"qwen3-0.6b": {}, "glm4-9b": {}, "qwen1.5-32b": {}, "gemma3-12b": {}}

REFERENCE = r"""
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.core import comms
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as T
from repro.models.sharding import AxisCtx
from repro.train.steps import build_serve
from repro.utils.tree import flatten_with_paths
ARCHS, OUT = json.loads(sys.argv[1]), sys.argv[2]
S, B, STEPS, M, CAP = map(int, sys.argv[3:8])


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_with_paths(tree).items()}


def records(log):
    return sorted((r.kind, list(r.axes), r.payload_bytes * r.mult, r.tag)
                  for r in log.records if "model" in r.axes)


out = {}
for arch, upd in ARCHS.items():
    cfg = get_config(arch).reduced().with_updates(**upd)
    params = T.init_params(cfg, jax.random.key(0), M)
    np.savez(f"{OUT}/{arch}.params.npz", **flat(params))
    batch = {k: jnp.asarray(v) for k, v in np.load(f"{OUT}/{arch}.batch.npz").items()}
    sb = build_serve(cfg, make_test_mesh(1, M), InputShape("t", CAP, B, "decode"))
    with comms.capture() as lp:
        jax.eval_shape(sb.prefill_step, params, batch)
    last, cache = sb.prefill_step(params, batch)
    tok = jnp.zeros((B, 1), jnp.int32)
    with comms.capture() as ld:
        jax.eval_shape(sb.serve_step, params, cache, tok)
    steps = {"last": np.asarray(last), **{"0/" + k: v for k, v in flat(cache).items()}}
    toks = []
    for t in range(STEPS):
        tok, cache = sb.serve_step(params, cache, tok)
        toks.append(np.asarray(tok).tolist())
        steps.update({f"{t + 1}/" + k: v for k, v in flat(cache).items()})
    np.savez(f"{OUT}/{arch}.serve.npz", **steps)
    out[arch] = {"tokens": toks, "prefill": records(lp), "decode": records(ld)}

argmax = {}
if os.path.exists(f"{OUT}/argmax.npz"):
    cases = np.load(f"{OUT}/argmax.npz")
    for m in (2, 4):
        fn = jax.jit(shard_map(lambda lg: T._distributed_argmax(lg, AxisCtx()),
                               mesh=make_test_mesh(1, m), in_specs=P(None, None, "model"),
                               out_specs=P(), check_vma=False))
        argmax[m] = {k: np.asarray(fn(jnp.asarray(v))).tolist() for k, v in cases.items()}
print("REF " + json.dumps({"archs": out, "argmax": argmax}))
"""


def prompt(cfg) -> dict[str, np.ndarray]:
    """S positions (patches or frames, then tokens) for B sequences."""
    return SyntheticBatches(cfg, InputShape("p", S, B, "prefill"), seed=1).batch(0)


def run_reference(archs: dict, out, n_devices: int = 2, argmax: dict | None = None,
                  msize: int = M, cap: int = S + STEPS) -> dict:
    """The reference's serving of each arch at model-axis size ``msize``
    (capacity ``cap``), in one subprocess of ``n_devices`` host devices:
    params, the prefill's last hidden state and the caches of every step
    land in ``out``; returns the tokens, the records and (with ``argmax``,
    four devices) the packed argmax of each case at 2 and 4 shards."""
    for arch, upd in archs.items():
        np.savez(out / f"{arch}.batch.npz",
                 **prompt(get_config(arch).reduced().with_updates(**upd)))
    if argmax:
        np.savez(out / "argmax.npz", **argmax)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=src, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(archs), str(out),
                          *map(str, (S, B, STEPS, msize, cap))], capture_output=True, text=True,
                         timeout=600, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    return json.loads(run.stdout.split("REF ", 1)[1])


def _close(got: torch.Tensor, want: np.ndarray, what: str, tol: tuple) -> None:
    want = want.astype(np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), want, rtol=tol[0],
                               atol=tol[1] * max(1.0, float(np.abs(want).max())), err_msg=what)


def _caches_close(cache, want: dict[str, np.ndarray], what: str, tol: tuple) -> None:
    got = flatten_with_paths(cache)
    assert sorted(got) == sorted(want), what
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, (what, path)
        if path.endswith("pos"):
            np.testing.assert_array_equal(t.numpy(), want[path], err_msg=f"{what} {path}")
        else:
            _close(t, want[path], f"{what} {path}", tol)


def _records(log) -> list:
    return sorted([r.kind, list(r.axes), r.payload_bytes * r.mult, r.tag] for r in log.records)


def serve_matches_reference(arch: str, upd: dict, out, want: dict, msize: int = M,
                            cap: int = S + STEPS) -> None:
    """The port's ``build_serve(..., msize)`` against the reference's run of
    :func:`run_reference`: the prefill, then STEPS steps from the
    reference's prefill cache, and the records of the prefill and of one
    step."""
    cfg = get_config(arch).reduced().with_updates(**upd)
    params = interop.params_from_numpy(dict(np.load(out / f"{arch}.params.npz")), cfg, "cpu",
                                       msize)
    batch = dict(np.load(out / f"{arch}.batch.npz"))
    ref = dict(np.load(out / f"{arch}.serve.npz"))
    steps = [{k.split("/", 1)[1]: v for k, v in ref.items() if k.startswith(f"{t}/")}
             for t in range(STEPS + 1)]
    tol = (RWKV_RTOL, RWKV_ATOL) if cfg.family == "ssm" else (RTOL, ATOL)
    sb = build_serve(cfg, InputShape("t", cap, B, "decode"), "cpu", msize=msize)
    with comms.capture() as lp:
        last, cache = sb.prefill_step(params, batch)
    _close(last, ref["last"], "last hidden", tol)
    _caches_close(cache, steps[0], "prefill", tol)
    assert _records(lp) == want["prefill"]

    cache = interop.cache_from_numpy(steps[0], cache)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for t in range(STEPS):
        with comms.capture() as ld:
            tok, cache = sb.serve_step(params, cache, tok)
        if t == 0:
            assert _records(ld) == want["decode"]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want["tokens"][t]),
                                      err_msg=f"step {t}")
        _caches_close(cache, steps[t + 1], f"step {t}", tol)
    assert int(cache["pos"]) == S + STEPS


def _argmax_cases() -> dict[str, np.ndarray]:
    """(B, 1, V) logits, V = 1024 (two or four shards of 512 or 256)."""
    rng = np.random.default_rng(5)
    V = 1024
    cases = {"random": rng.standard_normal((4, 1, V)).astype(np.float32)}
    low = rng.uniform(-8, 3, (4, 1, V)).astype(np.float32)
    low[0, 0, [7, 700]] = 3.5  # shards 0 and 1 of 2 (0 and 2 of 4) tie below 8
    low[1, 0, [300, 1000]] = 7.25
    low[2, 0, [10, 20]] = 5.0  # a tie inside shard 0: its first index
    low[3, 0, [600, 601, 900]] = 6.0
    high = rng.uniform(-20, 19, (3, 1, V)).astype(np.float32)
    high[0, 0, [100, 612]] = 20.0  # both shards win at 2 (and at 4: shards 0, 2)
    high[1, 0, [3, 260, 530, 1020]] = 20.0  # every shard of 4 ties
    high[2, 0, [511, 512]] = 24.0
    return {"random": cases["random"], "low": low, "high": high}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_model_axis_ref")
    return out, run_reference(ARCHS, out, n_devices=4, argmax=_argmax_cases())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_reference(arch, reference):
    out, ref = reference
    serve_matches_reference(arch, ARCHS[arch], out, ref["archs"][arch])


@pytest.mark.parametrize("msize", [2, 4])
def test_distributed_argmax_is_the_references_bitwise(msize, reference):
    _, ref = reference
    for name, logits in _argmax_cases().items():
        with comms.capture() as log:
            got = T._distributed_argmax(torch.from_numpy(logits), msize)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref["argmax"][str(msize)][name]),
                                      err_msg=name)
        assert _records(log) == [["pmax", ["model"], 4 * logits.shape[0], ""],
                                 ["psum", ["model"], 4 * logits.shape[0], ""]]


def test_a_tie_at_twenty_sums_the_winning_shards():
    """The reference's packing, by hand: at 20.0 both shards' packed values
    round to 2e7, so both win and the token is 100 + 612."""
    logits = torch.full((1, 1, 1024), -1.0)
    logits[0, 0, [100, 612]] = 20.0
    assert T._distributed_argmax(logits, 2).item() == 712
    logits[0, 0, 612] = 3.5
    assert T._distributed_argmax(logits, 2).item() == 100
    logits[0, 0, [100, 612]] = 3.5  # below 2**24 / 1e6 the lower shard wins
    assert T._distributed_argmax(logits, 2).item() == 100
