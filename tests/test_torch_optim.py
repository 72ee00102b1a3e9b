"""The port's ``adamw``, ``zero1`` and ``global_clip``
(repro_torch.optim.optimizers) against the JAX package's.

* ``adamw``: three in-place updates of f32 and bf16 leaves against the
  reference's (run eagerly, so no op is contracted into an FMA): moments
  and f32 parameters within rtol 1e-6 (``b**t`` is a ``pow`` in each
  library), bf16 parameters within one bf16 ulp, ``t`` exact.
* ``zero1``: the inner optimizer's arithmetic on each worker's 1/W slice,
  against the reference's ``zero1`` run under ``jax.vmap(axis_name="data")``
  with W = 4 (worker w's state slice is row w of the port's stacked state);
  the booked ``zero1_gather`` all-gathers equal the reference's capture and
  its formula, one worker's padded slice per leaf at the parameters' dtype.
  Over diverged rows (local SGD's one per worker, pod-local SGD's one per
  pod) every worker's slice of its own row, regathered into every row, as
  the reference's ``zero1`` regathers them.
* ``global_clip``: the clipped leaves within rtol 1e-6 (f32) and one bf16
  ulp (bf16); the norm sums leaf by leaf in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comms as jcomms
from repro.optim import optimizers as jopt
from repro_torch.core import comms
from repro_torch.optim import optimizers as opt
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

W = 4
SHAPES = [(7, 5), (1000,), (3, 4, 9)]  # 35 and 1000 elements pad to multiples of W
DTYPES = [np.float32, np.float32, "bfloat16"]
BF16_ULP = 2.0 ** -7


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in SHAPES]


def _params():
    return [torch.from_numpy(p).to(torch.bfloat16 if d == "bfloat16" else torch.float32)
            for p, d in zip(_leaves(0), DTYPES)]


def _jparams():
    return [jnp.asarray(p, jnp.bfloat16 if d == "bfloat16" else jnp.float32)
            for p, d in zip(_leaves(0), DTYPES)]


def _close(got: torch.Tensor, want, rtol=1e-6):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if got.dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP, atol=0)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_matches_reference(wd):
    o, jo = opt.adamw(wd=wd), jopt.adamw(wd=wd)
    params, jparams = _params(), _jparams()
    state, jstate = o.init(params), jo.init(jparams)
    for step in range(3):
        grads = _leaves(10 + step, 0.1)
        params, state = o.update([torch.from_numpy(g) for g in grads], state, params, 1e-2)
        jparams, jstate = jo.update([jnp.asarray(g) for g in grads], jstate, jparams, 1e-2)
    assert int(state["t"]) == int(jstate["t"]) == 3 and state["t"].dtype == torch.int32
    for p, jp, m, jm, v, jv in zip(params, jparams, state["m"], jstate["m"], state["v"],
                                   jstate["v"]):
        _close(m, jm)
        _close(v, jv)
        _close(p, jp)


@pytest.mark.parametrize("inner", ["momentum", "adamw"])
def test_zero1_matches_reference_under_vmap(inner):
    make = {"momentum": lambda m: m.momentum_sgd(0.9), "adamw": lambda m: m.adamw()}[inner]
    o, jo = opt.zero1(make(opt), W), jopt.zero1(make(jopt), ("data",))
    assert o.n_shards == W and o.name == jo.name
    params, jparams = _params(), _jparams()
    state = o.init(params)
    jinit = jax.vmap(lambda _: jo.init(jparams), axis_name="data")(jnp.arange(W))
    jstate = jinit
    run = jax.vmap(lambda g, st, p: jo.update(g, st, p, 1e-2), axis_name="data",
                   in_axes=(None, 0, None))
    for step in range(2):
        grads = _leaves(20 + step, 0.1)
        with comms.capture() as log:
            params, state = o.update([torch.from_numpy(g) for g in grads], state, params, 1e-2)
        with jcomms.capture() as jlog:
            new, jstate = run([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = [x[0] for x in new]  # every worker regathers the same parameters
        assert all((np.asarray(x) == np.asarray(x[0])).all() for x in new)
        if step == 0:
            recs = [(r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format)
                    for r in log.records]
            assert recs == [(r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format)
                            for r in jlog.records]
            want = [-(-int(np.prod(s)) // W) * (2 if d == "bfloat16" else 4)
                    for s, d in zip(SHAPES, DTYPES)]
            assert [r.payload_bytes for r in log.records] == want
            assert log.by_tag() == {"zero1_gather": sum(b * (W - 1) for b in want)}
    for p, jp in zip(params, jparams):
        _close(p, jp)
    flat_s = jax.tree.leaves(jstate["inner"])
    flat = [t for k in sorted(state["inner"]) for t in
            (state["inner"][k] if isinstance(state["inner"][k], list) else [state["inner"][k]])]
    assert len(flat) == len(flat_s)
    for t, jt in zip(flat, flat_s):  # worker w's slice is row w
        jt = np.asarray(jt)
        if t.dim() == 0:
            assert (jt == int(t)).all()
        else:
            _close(t, jt.reshape(t.shape))


def test_zero1_needs_the_bundles_worker_count():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.types import CommConfig
    from repro_torch.train.steps import build_bundle

    cfg = get_config("qwen3-0.6b").reduced()
    with pytest.raises(ValueError, match="shards"):
        build_bundle(cfg, CommConfig(), opt.zero1(opt.sgd(), 4), InputShape("t", 8, 2, "train"),
                     n_workers=2, device="cpu")


@pytest.mark.parametrize("max_norm", [0.0, 0.5, 1e3])
def test_global_clip_matches_reference(max_norm):
    grads = _params()
    got = opt.global_clip(grads, max_norm)
    want = jopt.global_clip(_jparams(), max_norm)
    if not max_norm:
        assert got is grads
    for g, w, src in zip(got, want, grads):
        assert g.dtype == src.dtype
        _close(g, w)


def _stacked(seed, rows, scale=1.0):
    """``rows`` diverged copies of every leaf: (rows, *shape) arrays."""
    return [np.stack([a + 0.01 * r for r in range(rows)]).astype(np.float32) * scale
            for a in _leaves(seed)]


def _as(x, d, lib):
    if lib == "torch":
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            torch.bfloat16 if d == "bfloat16" else torch.float32)
    return jnp.asarray(x, jnp.bfloat16 if d == "bfloat16" else jnp.float32)


@pytest.mark.parametrize("layout", ["local", "pod_local"])
@pytest.mark.parametrize("inner", ["momentum", "adamw"])
def test_zero1_over_diverged_rows_matches_reference(layout, inner):
    """ZeRO-1 where the workers' parameters diverge: under local SGD (one
    row per worker, each its own gradient) and under pod-local SGD (P 2 x
    D 2: one row per pod, each pod its own aggregate).  The reference's
    ``zero1`` under ``jax.vmap`` over the W workers: worker w updates slice
    w of its own row, and the all-gather hands every worker the
    concatenated slices, so every row is equal after the step; the port's
    ``update_rows`` computes the same rows and books the same all-gathers
    (by kind, bytes, n and tag; over ``("pod", "data")`` under pods).  jax's
    vmap cannot all-gather over two axes, so the reference's (pod, data)
    workers run as one axis in the mesh's pod-major order, which is its
    shard index p * D + d."""
    make = {"momentum": lambda m: m.momentum_sgd(0.9), "adamw": lambda m: m.adamw()}[inner]
    D = 2 if layout == "pod_local" else 1
    rows = W // D
    axes = ("pod", "data") if layout == "pod_local" else ("data",)
    o, jo = opt.zero1(make(opt), W), jopt.zero1(make(jopt), ("data",))
    p0 = _stacked(0, rows)
    params = [_as(x, d, "torch") for x, d in zip(p0, DTYPES)]
    state = o.init([p[0] for p in params])
    held = lambda arrs: [np.repeat(a, D, 0) for a in arrs]  # noqa: E731  (worker w: row w // D)
    jparams = [_as(x, d, "jax") for x, d in zip(held(p0), DTYPES)]
    run = jax.vmap(lambda g, st, p: jo.update(g, st, p, 1e-2), axis_name="data")
    jstate = jax.vmap(lambda _: jo.init([p[0] for p in jparams]), axis_name="data")(
        jnp.arange(W))
    for step in range(2):
        g = _stacked(30 + step, rows, 0.1)
        grads = [_as(x, d, "torch") for x, d in zip(g, DTYPES)]
        with comms.capture() as log, comms.over(axes):
            state = o.update_rows(lambda r: [x[r] for x in grads], state, params, 1e-2,
                                  lambda w: w // D)
        with jcomms.capture() as jlog:
            jparams, jstate = run([_as(x, d, "jax") for x, d in zip(held(g), DTYPES)],
                                  jstate, jparams)
        assert [(r.kind, r.payload_bytes, r.n_workers, r.tag) for r in log.records] == \
            [(r.kind, r.payload_bytes, r.n_workers, r.tag) for r in jlog.records]
        assert {r.axes for r in log.records} == {axes}
        for p, jp in zip(params, jparams):
            jp = np.asarray(jnp.asarray(jp, jnp.float32))
            assert (jp == jp[0]).all()  # every worker holds the same parameters
            for r in range(rows):
                assert torch.equal(p[r], p[0])
            _close(p[0], jp[0])
