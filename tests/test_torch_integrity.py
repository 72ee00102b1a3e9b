"""Gradient integrity in the port (``repro_torch.core.integrity``,
``gossip.masked_mixing_matrix``) against the JAX package's, the wire
kernels' alive-times-valid weights on the card, and a churn checkpoint
across the packages.

* Each injector (``corruption_flag``, ``corrupt_dense``, ``corrupt_codes``,
  ``corrupt_payload``, ``bitflip``) on the same flag and payload gives the
  reference's bytes and codes bitwise, every kind on f32 words, int8 codes
  and packed uint8 words, scalar and per-row flags; each validator
  (``dense_valid``, ``scale_valid``, ``code_valid``, ``packed2_valid``,
  with ``per_row``) the reference's bits.
* ``masked_mixing_matrix`` equals the reference's for random and edge
  masks (all alive: ``W`` back bitwise; all dead: the identity), rows
  summing to 1.
* The engine's ``spike`` and ``bitflip`` cells, every sync scheme x
  {``qsgd`` EF, ``qsgd_kernel`` EF}, against the reference's
  (test_torch_churn_engine.py's harness; tallies exact); corruption rates
  share one class program, the kind splits it.
* A churn and integrity checkpoint at W = 1 crosses the packages both ways:
  every leaf equal (``alive_prev``, ``qcount``, the tallies included) and
  the next step's loss within rtol 1e-4.
* On the card (gpu-marked): ``int8_acc``, ``sign_vote`` and ``tern_acc``
  with zero-weight rows that hold corrupted payloads, and a row whose NaN
  scale was selected out to weight 0, against their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.core import gossip as jgossip
from repro.core import integrity as J
from repro.core import simulate as JS
from repro.core.compression import get_compressor as jget
from repro.core.types import CommConfig as JCommConfig
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.launch.mesh import make_test_mesh
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant as jconstant
from repro.train.steps import build_bundle as jbuild_bundle
from repro.train.trainer import Trainer as JTrainer
from repro.utils.tree import flatten_with_paths as jflatten
from repro_torch.core import gossip
from repro_torch.core import integrity as P
from repro_torch.core import simulate as PS
from repro_torch.core.compression import get_compressor as pget
from repro_torch.core.types import CommConfig
from repro_torch.kernels import ops, ref
from repro_torch.optim import optimizers as opt
from repro_torch.utils.tree import flatten_with_paths
from test_torch_churn_engine import SCHEMES, COMPS, engine_matches_reference
from test_torch_churn_trainer import _noise, churn_draws
from test_torch_sync import _one_thread, cuda, port_run  # noqa: F401

KINDS = ("nan", "inf", "spike", "bitflip")
rng = np.random.default_rng(17)
X = (rng.standard_normal((4, 300)) * np.array([[1e-3], [1.0], [50.0], [1e5]])).astype(np.float32)
CODES = rng.integers(-16, 17, (4, 300)).astype(np.int8)
WORDS = rng.integers(0, 256, (4, 256)).astype(np.uint8)
FLAGS = np.array([1.0, 0.0, 1.0, 0.0], np.float32)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def test_corruption_flag_matches_reference():
    for s in range(8):
        key = jax.random.fold_in(jax.random.key(5), s)
        u = float(jax.random.uniform(jax.random.fold_in(key, J.CORRUPT_FOLD), ()))
        for rate in (0.0, 0.3, 0.9):
            for gate in (True, False):
                want = J.corruption_flag(key, rate, jnp.asarray(gate))
                got = P.corruption_flag(torch.tensor(u), rate, torch.tensor(gate))
                assert float(got) == float(want) and got.dtype == torch.float32


@pytest.mark.parametrize("kind", KINDS)
def test_corrupt_dense_is_bitwise(kind):
    for flag in (1.0, 0.0, FLAGS[:, None]):
        got = P.corrupt_dense(kind, torch.tensor(X), torch.tensor(flag))
        _eq(got.view(torch.int32), jax.lax.bitcast_convert_type(
            J.corrupt_dense(kind, jnp.asarray(X), jnp.asarray(flag)), jnp.int32), kind)


@pytest.mark.parametrize("kind", KINDS)
def test_corrupt_codes_and_payload_are_bitwise(kind):
    for codes in (CODES, WORDS):
        for flag in (1.0, FLAGS[:, None]):
            _eq(P.corrupt_codes(kind, torch.tensor(codes), torch.tensor(flag)),
                J.corrupt_codes(kind, jnp.asarray(codes), jnp.asarray(flag)), kind)
    payload = {"code": CODES[0], "norm": X[1, :1], "indices": np.arange(5, dtype=np.int32),
               "values": X[2, :5]}
    got = P.corrupt_payload(kind, {k: torch.tensor(v) for k, v in payload.items()},
                            torch.tensor(1.0))
    want = J.corrupt_payload(kind, {k: jnp.asarray(v) for k, v in payload.items()},
                             jnp.asarray(1.0))
    assert got.keys() == want.keys()
    for k in got:
        g, w = got[k], np.asarray(want[k])
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(np.int32)
        _eq(g, w, k)


def test_bitflip_flips_the_references_bits():
    _eq(P.bitflip(torch.tensor(X)).view(torch.int32),
        jax.lax.bitcast_convert_type(J._flip_f32(jnp.asarray(X)), jnp.int32))
    _eq(P.bitflip(torch.tensor(CODES)), J.corrupt_codes("bitflip", jnp.asarray(CODES), 1.0))
    _eq(P.bitflip(torch.tensor(WORDS)), J.corrupt_codes("bitflip", jnp.asarray(WORDS), 1.0))


@pytest.mark.parametrize("kind", KINDS)
def test_validators_match_reference(kind):
    xw = J.corrupt_dense(kind, jnp.asarray(X), jnp.asarray(FLAGS[:, None]))
    cw = J.corrupt_codes(kind, jnp.asarray(CODES), jnp.asarray(FLAGS[:, None]))
    ww = J.corrupt_codes(kind, jnp.asarray(WORDS), jnp.asarray(FLAGS[:, None]))
    tx, tc, tw = (torch.tensor(np.asarray(a)) for a in (xw, cw, ww))
    for per_row in (False, True):
        _eq(P.dense_valid(tx, per_row=per_row), J.dense_valid(xw, per_row=per_row))
        _eq(P.packed2_valid(tw, per_row=per_row), J.packed2_valid(ww, per_row=per_row))
        for bound in (16.0, np.array([16.0, 4.0, 16.0, 8.0], np.float32)):
            if np.ndim(bound) and not per_row:
                continue
            _eq(P.code_valid(tc, torch.tensor(bound), per_row=per_row),
                J.code_valid(cw, jnp.asarray(bound), per_row=per_row))
    _eq(P.scale_valid(tx[:, 0], tx[:, 1]), J.scale_valid(xw[:, 0], xw[:, 1]))
    assert P.KINDS == J.KINDS and P.SPIKE_FACTOR == J.SPIKE_FACTOR
    assert P.VALID_MAX == J.VALID_MAX and P.CORRUPT_FOLD == J.CORRUPT_FOLD


@pytest.mark.parametrize("n", [2, 3, 8])
def test_masked_mixing_matrix_matches_reference(n):
    W = np.asarray(jgossip.ring_mixing_matrix_traced(n, 0.3))
    masks = [np.ones(n), np.zeros(n), np.eye(n)[0]] + [
        (rng.uniform(size=n) > 0.4).astype(np.float32) for _ in range(4)]
    for m in masks:
        m = m.astype(np.float32)
        want = np.asarray(jgossip.masked_mixing_matrix(jnp.asarray(W), jnp.asarray(m)))
        got = gossip.masked_mixing_matrix(torch.tensor(W), torch.tensor(m)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(
        gossip.masked_mixing_matrix(torch.tensor(W), torch.ones(n)).numpy(), W)
    np.testing.assert_array_equal(
        gossip.masked_mixing_matrix(torch.tensor(W), torch.zeros(n)).numpy(), np.eye(n))
    # batched: (C, 1, n, n) matrices against (C, R, n) masks
    ms = torch.tensor(np.stack([masks[3:5], masks[5:7]]))
    got = gossip.masked_mixing_matrix(torch.tensor(W)[None, None].expand(2, 1, n, n), ms)
    for c in range(2):
        for r in range(2):
            torch.testing.assert_close(
                got[c, r], gossip.masked_mixing_matrix(torch.tensor(W), ms[c, r]))


CORRUPT = [(sync, name, kw, kind) for sync in SCHEMES for name, kw in COMPS
           for kind in ("spike", "bitflip")]


@pytest.mark.parametrize("sync,name,kw,kind", CORRUPT,
                         ids=[f"{s}-{n}-{k}" for s, n, _, k in CORRUPT])
def test_integrity_engine_matches_reference(sync, name, kw, kind):
    """30% corruption, quarantine_limit 2, over a dropout of 20% (bitflip
    with ``pull_avg``: the escalation's pull)."""
    over = dict(corruption_rate=0.3, corruption_kind=kind, quarantine_limit=2)
    if kind == "bitflip":
        over.update(dropout_rate=0.2, rejoin_policy="pull_avg")
    got = engine_matches_reference(sync, name, kw, **over)
    assert got["quarantine_rounds"][-1] > 0


def test_corruption_rates_share_one_class_program():
    base = dict(sync="bsp", n_workers=4, steps=10, lr=0.05, error_feedback=True, seed=5,
                compressor=pget("qsgd", levels=16), corruption_kind="nan")
    problem = PS.quadratic_problem(dim=16, n_workers=4, noise=0.05, seed=2)
    PS.engine_cache_clear()
    out = PS.simulate_training_classbatch(
        [PS.SimCfg(**base, corruption_rate=r) for r in (0.05, 0.1, 0.3)], problem, device="cpu")
    assert PS.engine_cache_stats().compiles == 1
    assert all(np.isfinite(c[0]["loss"]).all() for c in out)
    PS.simulate_training_batch(PS.SimCfg(**dict(base, corruption_kind="bitflip"),
                                         corruption_rate=0.1), problem, device="cpu")
    assert PS.engine_cache_stats().compiles == 2
    jbase = dict(base, compressor=jget("qsgd", levels=16))
    assert (PS.shape_class_key(PS.SimCfg(**base, corruption_rate=0.1))[5:]
            == JS.shape_class_key(JS.SimCfg(**jbase, corruption_rate=0.1))[5:])


# ---------------------------------------------------------------------------
# A churn checkpoint across the packages.
# ---------------------------------------------------------------------------

CKPT = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16}, wire_format="compressed",
            error_feedback=True, bucket_mb=4.0, dropout_rate=0.3, corruption_rate=0.4,
            corruption_kind="nan", quarantine_limit=2)


def _flat(tree):
    out = {}
    for k, v in flatten_with_paths(tree).items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().to(torch.float32).numpy() if v.dtype == torch.bfloat16 \
                else v.detach().numpy()
        elif v is not None:
            out[k] = v
    return out


def _jflat(tree):
    return {k: np.asarray(jnp.asarray(v, jnp.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in jflatten(tree).items()}


def _reference_trainer():
    cfg, shape, data = make_tiny_workload()
    jb = jbuild_bundle(cfg, make_test_mesh(data=1, model=1), JCommConfig(**CKPT),
                       jopt.momentum_sgd(0.9), shape, seed=0)
    return JTrainer(jb, data, jconstant(0.01), log_every=1)


def test_churn_checkpoint_crosses_the_packages(tmp_path):
    bundle, tr, state, _ = port_run(CommConfig(**CKPT), n_workers=1, steps=2, lr=0.01,
                                    optimizer=opt.momentum_sgd(0.9), churn_draws=churn_draws,
                                    noise=_noise)
    tr.save(str(tmp_path / "port"), state, 2)
    jt = _reference_trainer()
    jstate, step = jrestore(str(tmp_path / "port"), jt.init())
    assert step == 2
    port_flat, ref_flat = _flat(bundle.checkpoint_tree(state)), _jflat(jstate)
    assert port_flat.keys() == ref_flat.keys()
    assert {"comm/alive_prev", "comm/qcount", "comm/quarantine_total",
            "comm/escalation_total"} <= set(port_flat)
    for k in port_flat:
        np.testing.assert_array_equal(np.asarray(port_flat[k]), ref_flat[k], err_msg=k)
    jt.fit(jstate, 1, start_step=2)
    tr.fit(state, 1, start_step=2)
    assert jt.history[-1]["loss"] == pytest.approx(tr.history[-1]["loss"], rel=1e-4)

    jt = _reference_trainer()
    jstate = jt.fit(jt.init(), 2)
    jsave(str(tmp_path / "ref"), jstate, step=2)
    back, step = tr.restore(str(tmp_path / "ref"))
    assert step == 2
    port_flat, ref_flat = _flat(bundle.checkpoint_tree(back)), _jflat(jstate)
    assert port_flat.keys() == ref_flat.keys()
    for k in port_flat:
        np.testing.assert_array_equal(np.asarray(port_flat[k]), ref_flat[k], err_msg=k)


# ---------------------------------------------------------------------------
# On the card: the wire kernels with alive-times-valid weights.
# ---------------------------------------------------------------------------


def _weights(n_w):
    """Row 1 masked (alive 0), row 2 quarantined (its scale NaN, selected
    out to 0 as the rounds do), the others live."""
    scale = torch.linspace(0.5, 2.0, n_w)
    scale[2] = float("nan")
    alive = torch.ones(n_w)
    alive[1] = 0.0
    valid = P.scale_valid(scale)
    return torch.where(valid > 0, scale * alive, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [10_007, 155_582_464 // 64])
def test_weighted_wire_kernels_select_out_rows(cuda, n):
    n_w = 4
    w = _weights(n_w)
    codes = torch.tensor(np.random.default_rng(1).integers(-16, 17, (n_w, n)).astype(np.int8))
    codes[2] = P.bitflip(codes[2])  # a corrupted row, weight 0
    got = ops.int8_weighted_sum(codes.to(cuda), w.to(cuda))
    torch.testing.assert_close(got.cpu(), ref.int8_acc(codes, w), rtol=1e-6, atol=1e-5)
    x = torch.randn(n_w, n)
    signs = torch.stack([ops.sign_pack(r) for r in x])
    signs[1] = P.bitflip(signs[1])
    got = ops.sign_vote(signs.to(cuda), w.to(cuda), n)
    torch.testing.assert_close(got.cpu(), ref.sign_vote(signs, w, n), rtol=1e-6, atol=1e-5)
    tern = torch.tensor(np.random.default_rng(2).integers(-1, 2, (n_w, n)).astype(np.int8))
    packed = torch.stack([ops.tern_pack(t) for t in tern])
    packed[2] = P.bitflip(packed[2])
    assert float(P.packed2_valid(packed[2])) == 0.0
    got = ops.tern_acc(packed.to(cuda), w.to(cuda), n)
    torch.testing.assert_close(got.cpu(), ref.tern_acc(packed, w, n), rtol=1e-6, atol=1e-5)
    assert torch.isfinite(got).all()
