"""The port's aggregation layer (repro_torch.core.aggregate, comms,
compression) against the JAX package.

* Bucket plans equal the reference's (names, segments, sizes) on the tiny
  workload and at full qwen3-0.6b width (abstract shapes, nothing
  allocated), per-tensor and 32 MB-bucketed.
* A W=4 stacked round equals the composition of the reference's ops with
  the same uniform draws: per worker ``ops.qsgd_ef_fused`` (EF on) or
  ``ops.qsgd_quantize`` (EF off), then ``ops.int8_weighted_sum`` of the
  stacked codes over W.  Aggregate rtol 1e-6 (atol 1e-6 of its largest
  element: signed decodes cancel), EF residuals rtol 1e-5.
* Booked wire bytes equal ``repro.core.comms.CollRecord(...).wire_bytes``
  for the same payloads and n = W.
* A W=4 round of the port's ``aggregate_buckets`` equals the reference's
  own ``aggregate_buckets`` run under ``jax.vmap(axis_name="data")`` (its
  collectives reduce over the vmap axis, its Pallas kernels run in
  interpret mode), over two rounds so the residuals are non-zero, for the
  1-bit sign wires, the 2-bit ternary wire, the majority vote, the
  gather-and-decompress reduce, the sparsifiers' sparse scatter-add (with
  gTop-k's re-sparsify) and masked sum, the general
  ``pre_compress``/``post_compress`` path, the plain ``qsgd`` on the int8
  wire (its ``s`` gathered), the other quantizers, the policies and ATOMO
  by gather-and-decompress, PowerSGD's factor psums (Q from the
  reference's draw, compared up to column sign), the bf16 wire, a bf16
  all-reduce and the ring and rhd schedules (bitwise); the booked records
  (kind, payload bytes, wire format) equal the reference's capture.  The
  sparsifier cells round their inputs to bf16, so magnitudes tie as in the
  trainer.
* The ring and rhd schedules alone at W = 3 and 8 against the reference's
  ``collectives.allreduce`` under ``jax.vmap``: bitwise, hops booked alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import aggregate as jagg
from repro.core import comms as jcomms
from repro.core.compression import get_compressor as jget_compressor
from repro.core.types import CommConfig as JCommConfig
from repro.core.types import CommKnobs as JCommKnobs
from repro.experiments.trainer_substrate import make_tiny_workload
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.core import aggregate, comms
from repro_torch.core.compression import get_compressor
from repro_torch.core.types import CommConfig, validate
from repro_torch.models import transformer as T
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

QSGD = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16})


def _plans(full: bool, bucket_mb: float):
    if full:
        jcfg, cfg = jget("qwen3-0.6b"), get_config("qwen3-0.6b")
    else:
        jcfg = make_tiny_workload()[0]
        cfg = get_config("qwen3-0.6b").reduced().with_updates(
            vocab=128, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
    want = jagg.make_bucket_plan(JCommConfig(bucket_mb=bucket_mb, **QSGD),
                                 JT.abstract_params(jcfg, 1)[0])
    got = aggregate.make_bucket_plan(CommConfig(bucket_mb=bucket_mb, **QSGD), T.param_defs(cfg))
    return want, got


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("bucket_mb", [0.0, 32.0])
def test_bucket_plan_matches_reference(full, bucket_mb):
    want, got = _plans(full, bucket_mb)
    assert len(got.buckets) == len(want.buckets)
    for b, w in zip(got.buckets, want.buckets):
        assert (b.name, b.segments, b.size, b.compressor_name, b.compressor_kwargs) == (
            w.name, w.segments, w.size, w.compressor_name, w.compressor_kwargs)
    assert aggregate.plan_signature(got) == jagg.plan_signature(want)
    assert got.knob_values() == want.knob_values()


def test_full_width_plan_sizes():
    _, got = _plans(True, 0.0)
    sizes = [b.size for b in got.buckets]
    assert len(sizes) == 13 and sum(sizes) == 596_049_920
    assert max(sizes) == 155_582_464  # embed/embedding


# ---------------------------------------------------------------------------
# One stacked W=4 round against the reference's ops.
# ---------------------------------------------------------------------------

W = 4
SHAPES = {"a": (1000,), "b": (37, 11), "c": (4096,), "d": (9000,)}


def _round_inputs(seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((W, int(np.prod(s)))) * 0.1).astype(np.float32)
            for _, s in sorted(SHAPES.items())]


def _u(step, w, i, n):
    rng = np.random.default_rng(1000 * step + 10 * w + i)
    return rng.random(n, dtype=np.float32)


def _noise(step, w, i, n):
    return torch.from_numpy(_u(step, w, i, n))


def _reference_round(bufs, ef, step, error_feedback, decay):
    aggs, new_ef = [], []
    for i, g in enumerate(bufs):
        codes, norms, e_rows = [], [], []
        for w in range(W):
            u = jnp.asarray(_u(step, w, i, g.shape[1]))
            if error_feedback:
                c, nrm, e_new = jops.qsgd_ef_fused(jnp.asarray(g[w]), jnp.asarray(ef[i][w]), u,
                                                   levels=16, decay=decay)
                e_rows.append(np.asarray(e_new))
            else:
                c, nrm = jops.qsgd_quantize(jnp.asarray(g[w]), u, levels=16)
            codes.append(c)
            norms.append(nrm[0])
        wts = jnp.stack(norms) / jnp.float32(16)
        aggs.append(np.asarray(jops.int8_weighted_sum(jnp.stack(codes), wts) / W))
        new_ef.append(np.stack(e_rows) if error_feedback else None)
    return aggs, new_ef


@pytest.mark.parametrize("error_feedback,decay", [(True, 1.0), (True, 0.9), (False, 1.0)])
def test_stacked_round_matches_reference_ops(error_feedback, decay):
    comm = CommConfig(wire_format="compressed", error_feedback=error_feedback,
                      ef_decay=decay, **QSGD)
    validate(comm)
    plan = aggregate.make_bucket_plan(comm, {k: torch.empty(s) for k, s in SHAPES.items()})
    state = aggregate.init_comm_state(comm, plan, W, "cpu")
    ef = [np.zeros((W, b.size), np.float32) for b in plan.buckets]
    for step in range(2):  # the second round starts from non-zero residuals
        bufs = _round_inputs(step)
        got, state = aggregate.aggregate_buckets(comm, plan, [torch.from_numpy(b) for b in bufs],
                                                 state, _noise)
        want, want_ef = _reference_round(bufs, ef, step, error_feedback, decay)
        for g, w in zip(got, want):
            # atol: rtol of the largest element — sums of signed decodes
            # cancel, and the two sides sum W terms in different orders
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
        if error_feedback:
            for e, w in zip(state["ef"], want_ef):
                np.testing.assert_allclose(e.numpy(), w, rtol=1e-5, atol=1e-7)
            ef = want_ef
    assert state["step"] == 2


def test_dense_round_is_the_worker_mean():
    comm = CommConfig()
    plan = aggregate.make_bucket_plan(comm, {k: torch.empty(s) for k, s in SHAPES.items()})
    bufs = _round_inputs(3)
    got, _ = aggregate.aggregate_buckets(comm, plan, [torch.from_numpy(b) for b in bufs],
                                         aggregate.init_comm_state(comm, plan, W, "cpu"), _noise)
    for g, b in zip(got, bufs):
        np.testing.assert_allclose(g.numpy(), b.mean(0), rtol=1e-6, atol=1e-8)


def test_booked_wire_bytes_match_reference_formula():
    comm = CommConfig(wire_format="compressed", error_feedback=True, **QSGD)
    plan = aggregate.make_bucket_plan(comm, {k: torch.empty(s) for k, s in SHAPES.items()})
    bufs = [torch.from_numpy(b) for b in _round_inputs(0)]
    with comms.capture() as log:
        aggregate.aggregate_buckets(comm, plan, bufs, aggregate.init_comm_state(comm, plan, W, "cpu"),
                                    _noise)
    want = []
    for b in plan.buckets:  # int8 codes, then the f32 norm, per bucket
        want.append(jcomms.CollRecord("all_gather", ("data",), b.size, 1.0, W, "grad_agg", "int8"))
        want.append(jcomms.CollRecord("all_gather", ("data",), 4, 1.0, W, "grad_agg", "f32"))
    assert [(r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format) for r in log.records] == [
        (r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format) for r in want]
    assert [r.wire_bytes for r in log.records] == [r.wire_bytes for r in want]
    assert log.by_tag() == {"grad_agg": sum(r.wire_bytes for r in want)}

    dense = CommConfig()
    dplan = aggregate.make_bucket_plan(dense, {k: torch.empty(s) for k, s in SHAPES.items()})
    with comms.capture() as log:
        aggregate.aggregate_buckets(dense, dplan, bufs, aggregate.init_comm_state(dense, dplan, W, "cpu"),
                                    _noise)
    assert [r.wire_bytes for r in log.records] == [
        jcomms.CollRecord("psum", ("data",), 4 * b.size, 1.0, W).wire_bytes for b in dplan.buckets]


def test_seeded_noise_is_reproducible_per_round():
    noise = aggregate.seeded_noise(7, "cpu")
    a, b = noise(3, 1, 2, 1000), noise(3, 1, 2, 1000)
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    assert not torch.equal(a, noise(3, 2, 2, 1000))
    assert not torch.equal(a, aggregate.seeded_noise(8, "cpu")(3, 1, 2, 1000))


@pytest.mark.parametrize("kw,err", [
    (dict(wire_format="packed"), ValueError),
    # the reference's bundle_spec: a bf16 agg_dtype means nothing on a
    # compressed wire that carries a compressor's payload
    (dict(wire_format="compressed", agg_dtype="bfloat16", **QSGD), ValueError),
    # churn, rejoin and integrity are ported: these cells hold a value the
    # reference's bundle_spec refuses, whichever other part they select
    (dict(churn=True, dropout_rate=1.0), ValueError),
    (dict(overlap="pipelined", churn=True, rejoin_policy="bogus"), ValueError),
    (dict(aggregator="gossip", churn=True, corruption_kind="bogus"), ValueError),
    (dict(sync="local", dropout_rate=1.5), ValueError),
    (dict(warmup_steps=10, **QSGD, wire_format="compressed", worker_dropout=(0.1, 1.0)),
     ValueError),
    (dict(sync="post_local", post_local_switch=10, pod_local=True, churn=True,
          quarantine_limit=0), ValueError),
    (dict(pod_local=True, corruption_rate=0.1), ValueError),  # a rate without a kind
    (dict(corruption_rate=1.0, corruption_kind="nan", error_feedback=True, **QSGD),
     ValueError),
    (dict(churn=True, rejoin_policy="pull"), ValueError),
    (dict(collective="tree"), ValueError),  # none of the reference's schedules
    # no compressed-domain reduction for a sparsifier (or for PowerSGD), as
    # in the reference
    (dict(compressor="topk", wire_format="compressed"), ValueError),
    (dict(compressor="threshold", wire_format="compressed"), ValueError),
    (dict(compressor="powersgd", wire_format="compressed"), ValueError),
])
def test_validate_rejects_unported_cells(kw, err):
    with pytest.raises(err):
        validate(CommConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(momentum_correction=0.9, **QSGD, wire_format="compressed"),
    dict(**QSGD),  # gather-and-decompress on the dense wire
    dict(error_feedback=True),  # EF on the dense wire (a zero residual)
    dict(compressor="signsgd_packed", wire_format="compressed", error_feedback=True,
         ef_decay=0.9, local_clip=1.0),
    dict(compressor="signsgd", wire_format="compressed"),
    dict(compressor="signsgd"),  # int8 majority on the dense wire
    dict(compressor="signsgd_packed", error_feedback=True),
    dict(compressor="terngrad_kernel", wire_format="compressed", error_feedback=True),
    dict(compressor="terngrad", compressor_kwargs={"clip_sigma": 2.5},
         wire_format="compressed"),
    dict(compressor="terngrad_kernel"),  # gather-and-decompress on the dense wire
    dict(compressor="topk", error_feedback=True),  # sparse gather and scatter-add
    dict(compressor="gtopk", momentum_correction=0.9, error_feedback=True),
    dict(compressor="randomk", compressor_kwargs={"ratio": 0.05}),
    dict(compressor="sbc"),
    dict(compressor="stc"),
    dict(compressor="threshold", error_feedback=True),  # the sum reduction
    dict(compressor="adaptive_threshold", compressor_kwargs={"proportion": 0.05}),
    dict(compressor="wangni"),
    dict(compressor="variance_sparse", local_clip=1.0),
    dict(**QSGD, per_tensor_rules=[("embed", "topk", {})]),
    # a rule whose compressor has no wire_reduce falls through to its
    # reduce_mode on the compressed wire, as the reference's _aggregate_one
    dict(**QSGD, wire_format="compressed", per_tensor_rules=[("embed", "topk", {})]),
    dict(**QSGD, wire_format="compressed", error_feedback=True,
         per_tensor_rules=[("embed", "threshold", {})]),
    # PowerSGD's factor psums, globally or as a rule
    dict(compressor="powersgd", error_feedback=True),
    dict(per_tensor_rules=[("embed", "powersgd", {})]),
    # the bf16 wire: no compressor, or a "none" rule, on the compressed wire
    dict(wire_format="compressed"),
    dict(wire_format="compressed", per_tensor_rules=[("embed", "none", {})], **QSGD),
    # a bf16 dense all-reduce and the hand-written schedules
    dict(agg_dtype="bfloat16"),
    dict(agg_dtype="bfloat16", collective="ring"),
    dict(collective="rhd"),
    # pod-local SGD and pipelined overlap (staleness 0 and 1)
    dict(pod_local=True, **QSGD, wire_format="compressed", error_feedback=True),
    dict(sync="post_local", post_local_switch=10, pod_local=True),
    dict(overlap="pipelined", **QSGD, wire_format="compressed", error_feedback=True),
    dict(overlap="pipelined", overlap_staleness=0, stale_scale=0.5),
    # churn, rejoin and integrity over the routes
    dict(churn=True, rejoin_policy="pull_avg", **QSGD, wire_format="compressed"),
    dict(dropout_rate=0.3, worker_dropout=(0.1, 0.0, 0.5, 0.0), churn_start=2, churn_end=9),
    dict(corruption_rate=0.1, corruption_kind="nan", error_feedback=True, **QSGD),
    dict(churn=True, corruption_kind="bitflip", overlap="pipelined"),
    dict(aggregator="gossip", gossip_compress="choco", compressor="topk", dropout_rate=0.2),
    dict(pod_local=True, compressor="powersgd", dropout_rate=0.1, quarantine_limit=5),
])
def test_validate_accepts_ported_cells(kw):
    validate(CommConfig(**kw))


@pytest.mark.parametrize("mode", ["sum", "powersgd"])
def test_unported_reductions_raise(mode):
    """Both reduce modes are ported now: ``sum`` routes to the sum reduction
    and ``powersgd`` to PowerSGD's factor psums (whatever the wire: the
    reference dispatches on the reduce mode first); an unknown mode still
    raises."""
    comp = get_compressor("signsgd", reduce_mode=mode)
    for wire in ("dense", "compressed"):
        route = aggregate.bucket_route(CommConfig(compressor="signsgd", wire_format=wire), comp)
        assert route == ("sign" if (mode, wire) == ("sum", "compressed") else mode)
    with pytest.raises(NotImplementedError, match="bogus"):
        aggregate.bucket_route(CommConfig(compressor="signsgd"),
                               get_compressor("signsgd", reduce_mode="bogus"))


def test_qsgd_kernel_levels_bound():
    with pytest.raises(ValueError, match="int8"):
        get_compressor("qsgd_kernel", levels=200).runtime_params()
    assert get_compressor("qsgd_kernel", levels=16).wire_bits(1000) == 1000 * 5 + 32


# ---------------------------------------------------------------------------
# A W=4 round against the reference's own aggregate_buckets under jax.vmap.
# ---------------------------------------------------------------------------

PACKED = dict(compressor="signsgd_packed")
SIGN = dict(compressor="signsgd")
TERN = dict(compressor="terngrad_kernel")
VMAP_CELLS = {
    "packed-cwire-ef1": dict(wire_format="compressed", error_feedback=True, **PACKED),
    "packed-cwire-ef0.9": dict(wire_format="compressed", error_feedback=True, ef_decay=0.9,
                               **PACKED),
    "packed-cwire": dict(wire_format="compressed", **PACKED),
    "sign-cwire": dict(wire_format="compressed", **SIGN),
    "packed-dense": dict(**PACKED),
    "sign-dense": dict(**SIGN),
    "qsgd-dense-ef": dict(error_feedback=True, **QSGD),
    "packed-cwire-ef-mom-clip": dict(wire_format="compressed", error_feedback=True,
                                     momentum_correction=0.9, local_clip=1.0, **PACKED),
    # the ternary cells keep ef_decay 1.0 and no momentum correction: under
    # jit XLA contracts e*decay + g into one FMA, and an ulp of a moves
    # max|a|, which can flip a stochastic code at a dither boundary (decay
    # 1.0 makes e*decay + g exact either way)
    "tern-cwire-ef": dict(wire_format="compressed", error_feedback=True, **TERN),
    "tern-cwire": dict(wire_format="compressed", **TERN),
    "terngrad-cwire-clip": dict(wire_format="compressed", compressor="terngrad",
                                compressor_kwargs={"clip_sigma": 2.5}),
    "tern-dense": dict(**TERN),
    # the sparsifiers, on inputs rounded to bf16 (magnitudes tie, as in the
    # trainer's widened bf16 gradients): the sparse gather and scatter-add
    "topk-ef": dict(compressor="topk", error_feedback=True),
    "gtopk-mom": dict(compressor="gtopk", compressor_kwargs={"ratio": 0.05},
                      momentum_correction=0.9),
    "randomk": dict(compressor="randomk", compressor_kwargs={"ratio": 0.05}),
    "sbc": dict(compressor="sbc", compressor_kwargs={"ratio": 0.05}),
    "stc": dict(compressor="stc", compressor_kwargs={"ratio": 0.05}),
    # ... and the sum of masked dense payloads
    "threshold-ef": dict(compressor="threshold", compressor_kwargs={"tau": 0.1},
                         error_feedback=True),
    "adaptive-threshold": dict(compressor="adaptive_threshold",
                               compressor_kwargs={"proportion": 0.05}),
    "wangni": dict(compressor="wangni", compressor_kwargs={"ratio": 0.05}),
    "variance-sparse": dict(compressor="variance_sparse"),
    # a mixed plan on the compressed wire: QSGD's fused EF int8 route on
    # a, b, c and top-k's sparse gather on the embed bucket (MIXED_SHAPES)
    "qsgd-cwire-ef-topk-rule": dict(wire_format="compressed", error_feedback=True,
                                    per_tensor_rules=[("embed", "topk", {})], **QSGD),
    # the quantization twins and the policies: the plain qsgd on the int8
    # compressed wire (its payload's s gathered after the norm), the rest
    # gathered and decoded on the dense wire
    "qsgd-cwire-ef": dict(compressor="qsgd", compressor_kwargs={"levels": 16},
                          wire_format="compressed", error_feedback=True),
    "qsgd-cwire": dict(compressor="qsgd", compressor_kwargs={"levels": 16},
                       wire_format="compressed"),
    "onebit-ef": dict(compressor="onebit", error_feedback=True),
    "natural": dict(compressor="natural"),
    "natural-dithering": dict(compressor="natural_dithering", compressor_kwargs={"levels": 8}),
    # threshold 4096 straddles the buckets: a and b go as f16, c and d as q8
    "size-adaptive": dict(compressor="size_adaptive", compressor_kwargs={"threshold": 4096}),
    "adaptive-qsgd": dict(compressor="adaptive_qsgd", compressor_kwargs={"var_target": 1.0}),
    # PowerSGD's two factor psums, Q taken from the reference's draw
    "powersgd-ef": dict(compressor="powersgd", compressor_kwargs={"rank": 2},
                        error_feedback=True),
    "powersgd": dict(compressor="powersgd", compressor_kwargs={"rank": 2}),
    "atomo": dict(compressor="atomo_svd"),
    # no compressor: the bf16 wire (widening psum), a "none" rule on the
    # compressed wire, a bf16 all-reduce, and the ring and rhd schedules
    # (their sizes 1000, 407, 4096 and 9000 pad 407 to a multiple of W)
    "bf16-wire": dict(wire_format="compressed"),
    "qsgd-cwire-ef-none-rule": dict(wire_format="compressed", error_feedback=True,
                                    per_tensor_rules=[("embed", "none", {})], **QSGD),
    "agg-bf16": dict(agg_dtype="bfloat16"),
    "ring": dict(collective="ring"),
    "rhd": dict(collective="rhd"),
    "agg-bf16-ring": dict(agg_dtype="bfloat16", collective="ring"),
    "agg-bf16-rhd": dict(agg_dtype="bfloat16", collective="rhd"),
}
#: a, b, c and an ``embed`` bucket of d's size: the same sizes in the same
#: sorted order as SHAPES, so the cells share their inputs
MIXED_SHAPES = {"a": (1000,), "b": (37, 11), "c": (4096,), "embed": (9000,)}
CELL_SHAPES = {"qsgd-cwire-ef-topk-rule": MIXED_SHAPES,
               "qsgd-cwire-ef-none-rule": MIXED_SHAPES}
SPARSE = ("topk", "gtopk", "randomk", "sbc", "stc", "threshold", "adaptive_threshold",
          "wangni", "variance_sparse")
#: cells whose aggregate sums scaled decodes or sparse payloads, which
#: cancel and are summed in other orders (the rest are exact sign outputs,
#: or sums of the same f32 or bf16 values in the reference's order)
DECODED = ("qsgd_kernel", "terngrad_kernel", "terngrad", "qsgd", "onebit", "natural",
           "natural_dithering", "size_adaptive", "adaptive_qsgd", "powersgd",
           "atomo_svd") + SPARSE
#: cells run with the reference's traced knob tree, as its trainer runs
#: them: ``compress_p`` then adds qsgd's ``s`` and natural dithering's ``L``
#: to the payload (without knobs the reference takes the baked ``compress``)
KNOBBED = ("qsgd-cwire-ef", "qsgd-cwire", "natural-dithering", "adaptive-qsgd")
#: decoded-sum tolerance (rtol, and atol as a share of the largest element)
#: where it is not 1e-6: PowerSGD goes through another matmul order and a
#: QR; ATOMO's singular vectors are determined only to about eps ||M|| / gap
#: (the bulk of a random spectrum is closely spaced), measured up to 2.5e-4
#: of the largest element on the 90 x 100 bucket
DECODED_TOL = {"powersgd": 1e-5, "powersgd-ef": 1e-5, "atomo": 1e-3}


def _vmap_inputs(step, bf16=False):
    """Gradients with planted +-0.0, and 2-2 sign splits across the W=4
    workers (majority ties) at every fifth element; ``bf16`` rounds them to
    bf16 and back."""
    out = []
    for g in _round_inputs(100 + step):
        g[2, ::5], g[3, ::5] = -g[0, ::5], -g[1, ::5]
        g[:, ::97] = 0.0
        g[1, ::89] = -0.0
        if bf16:
            g = torch.from_numpy(g).to(torch.bfloat16).to(torch.float32).numpy()
        out.append(g)
    return out


def _key_noise(step, w, i, n):
    """The reference's draw for worker w, bucket i under key(step)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(step), w), i)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))


def _records(log):
    return [(r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format) for r in log.records]


@pytest.mark.parametrize("cell", list(VMAP_CELLS))
def test_round_matches_reference_aggregate_under_vmap(cell):
    kw = VMAP_CELLS[cell]
    comm, jcomm = CommConfig(**kw), JCommConfig(**kw)
    validate(comm)
    cell_shapes = CELL_SHAPES.get(cell, SHAPES)
    shapes = {k: torch.empty(s) for k, s in cell_shapes.items()}
    plan = aggregate.make_bucket_plan(comm, shapes)
    jplan = jagg.make_bucket_plan(jcomm, {k: jnp.zeros(s) for k, s in cell_shapes.items()})
    state = aggregate.init_comm_state(comm, plan, W, "cpu")
    jstate = jax.tree.map(lambda x: jnp.broadcast_to(x, (W,) + x.shape),
                          jagg.init_comm_state(jcomm, jplan))
    if "psgd_q" in state:  # the reference's key(1000 + i) draw
        assert [q.shape for q in state["psgd_q"]] == [q[0].shape for q in jstate["psgd_q"]]
        state["psgd_q"] = [torch.from_numpy(np.array(q[0])) for q in jstate["psgd_q"]]
    knobs = (JCommKnobs.from_comm(jcomm, jplan.knob_values()).as_tree() if cell in KNOBBED
             else None)
    run = jax.jit(jax.vmap(lambda b, st, key, kn: jagg.aggregate_buckets(
        jcomm, jplan, b, st, key, ("data",), knobs=kn),
        axis_name="data", in_axes=(0, 0, None, None)))
    name = kw.get("compressor", "none")
    decoded = name in DECODED or bool(kw.get("per_tensor_rules"))
    tol = DECODED_TOL.get(cell, 1e-6)
    for step in range(2):  # the second round starts from non-zero residuals
        bufs = _vmap_inputs(step, bf16=name in SPARSE)
        with comms.capture() as log:
            got, state = aggregate.aggregate_buckets(
                comm, plan, [torch.from_numpy(b) for b in bufs], state, _key_noise)
        with jcomms.capture() as jlog:
            want, jstate = run([jnp.asarray(b) for b in bufs], jstate, jax.random.key(step),
                               knobs)
        if step == 0:  # the reference books while tracing, on the first call
            assert _records(log) == _records(jlog)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert (w == w[0]).all()  # every worker holds the same aggregate
            if decoded:  # signed decodes cancel: atol of the largest element
                np.testing.assert_allclose(g.numpy(), w[0], rtol=tol,
                                           atol=tol * np.abs(w).max())
            else:  # sign outputs, and sums in the reference's order, are exact
                np.testing.assert_array_equal(g.numpy(), w[0])
        for q, jq in zip(state.get("psgd_q", []), jstate.get("psgd_q", [])):
            # Q' is defined up to the sign of each column (P's, from the QR)
            jq = np.asarray(jq)
            assert (jq == jq[0]).all()
            q, jq = q.numpy().reshape(-1, 2), jq[0].reshape(-1, 2)
            q = q * np.sign(np.sum(q * jq, axis=0))
            np.testing.assert_allclose(q, jq, rtol=1e-5, atol=1e-5 * np.abs(jq).max())
        for k in ("ef", "u"):
            assert (k in state) == (k in jstate)
            for e, je in zip(state.get(k, []), jstate.get(k, [])):
                je = np.asarray(je)
                if e is None:  # no compressor: the reference's residual stays zero
                    assert not je.any()
                    continue
                # atol 1e-6 of the operands' scale: under jit XLA contracts
                # e*decay + g (and m*u + g) into one FMA, so a may differ by
                # an ulp, and e = a - C(a) cancels; a sign decode is +-1, so
                scale = np.abs(je).max() + (1.0 if k == "ef" and not decoded else 0.0)
                np.testing.assert_allclose(e.numpy(), je, rtol=1e-6, atol=1e-6 * scale)
    assert state["step"] == 2 == int(jstate["step"][0])


def test_majority_vote_breaks_ties_to_plus_one():
    """Two workers vote +1 and two vote -1 at every element: both majority
    reductions (int8 psum on the dense wire, packed vote on the compressed
    wire) resolve every tie to +1, as the reference does."""
    g = np.ones((W, 9000), np.float32)
    g[2:] = -1.0
    for wire in ("dense", "compressed"):
        comm = CommConfig(compressor="signsgd", wire_format=wire)
        plan = aggregate.make_bucket_plan(comm, {"d": torch.empty(9000)})
        got, _ = aggregate.aggregate_buckets(comm, plan, [torch.from_numpy(g)],
                                             aggregate.init_comm_state(comm, plan, W, "cpu"),
                                             _key_noise)
        assert torch.equal(got[0], torch.ones(9000))


def test_sign_wire_books_packed_payload():
    """A 1000-element bucket on the compressed sign wire books one all-gather
    of the padded 1024-byte tile as packed1; on the dense wire the same
    payload books as int8; signsgd on the dense wire books an int8 psum."""
    bufs = [torch.from_numpy(_vmap_inputs(0)[0])]
    want = {("compressed", "signsgd_packed"): ("all_gather", 1024, "packed1"),
            ("dense", "signsgd_packed"): ("all_gather", 1024, "int8"),
            ("dense", "signsgd"): ("psum", 1000, "int8")}
    for (wire, name), rec in want.items():
        comm = CommConfig(compressor=name, wire_format=wire)
        plan = aggregate.make_bucket_plan(comm, {"a": torch.empty(1000)})
        with comms.capture() as log:
            aggregate.aggregate_buckets(comm, plan, bufs,
                                        aggregate.init_comm_state(comm, plan, W, "cpu"),
                                        _key_noise)
        assert [(r.kind, r.payload_bytes, r.wire_format) for r in log.records] == [rec]


def test_tern_wire_books_packed_payload():
    """A 1000-element bucket on the compressed ternary wire books one
    all-gather of the padded 1024-byte tile as packed2, then the f32 scale,
    as the reference's ``_compressed_reduce`` does; on the dense wire the
    payload leaves book as int8 codes and the f32 scale."""
    bufs = [torch.from_numpy(_vmap_inputs(0)[0])]
    want = {("compressed", "terngrad_kernel"): [("all_gather", 1024, "packed2"),
                                                ("all_gather", 4, "f32")],
            ("compressed", "terngrad"): [("all_gather", 1024, "packed2"),
                                         ("all_gather", 4, "f32")],
            ("dense", "terngrad_kernel"): [("all_gather", 1000, "int8"),
                                           ("all_gather", 4, "f32")]}
    for (wire, name), recs in want.items():
        comm = CommConfig(compressor=name, wire_format=wire)
        plan = aggregate.make_bucket_plan(comm, {"a": torch.empty(1000)})
        with comms.capture() as log:
            aggregate.aggregate_buckets(comm, plan, bufs,
                                        aggregate.init_comm_state(comm, plan, W, "cpu"),
                                        _key_noise)
        assert [(r.kind, r.payload_bytes, r.wire_format) for r in log.records] == recs


@pytest.mark.parametrize("name", ["terngrad_kernel", "terngrad"])
def test_tern_route_and_wire_bits(name):
    comp = get_compressor(name)
    assert aggregate.bucket_route(CommConfig(compressor=name, wire_format="compressed"),
                                  comp) == "tern"
    assert aggregate.bucket_route(CommConfig(compressor=name), comp) == "gather"
    assert comp.wire_bits(1000) == 1000 * 2 + 32


@pytest.mark.parametrize("n", [1000, 100_003])
@pytest.mark.parametrize("name,clip", [("terngrad_kernel", None), ("terngrad", 0.0),
                                       ("terngrad", 2.5)])
def test_tern_compressors_match_reference(name, clip, n):
    """Both ternary compressors against the reference's on its own draw:
    codes and scale bitwise without clipping (max|x| is exact in any order;
    the kernel multiplies by 1/smax, the twin divides by s, each as its
    reference does).  With clip_sigma 2.5 the population std sums in
    another order than XLA's, so the scale is held to rtol 1e-6 and the
    codes where the draw is more than 1e-5 from p = |clip(x)| / s."""
    x = (np.random.default_rng(n).standard_normal(n) * 0.1).astype(np.float32)
    x[::97] = 0.0
    key = jax.random.key(n)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    comp, jcomp = get_compressor(name), jget_compressor(name)
    if clip is None:
        got, want = comp.compress(u, torch.from_numpy(x)), jcomp.compress(key, jnp.asarray(x))
    else:
        got = comp.compress_p(u, torch.from_numpy(x), {"clip_sigma": clip})
        want = jcomp.compress_p(key, jnp.asarray(x), {"clip_sigma": clip})
    tern, scale = got.payload["tern"].numpy(), got.payload["scale"].numpy()
    want_t, want_s = np.asarray(want.payload["tern"]), np.asarray(want.payload["scale"])
    assert tern.dtype == want_t.dtype == np.int8 and scale.shape == want_s.shape == (1,)
    if not clip:
        np.testing.assert_array_equal(scale, want_s)
        np.testing.assert_array_equal(tern, want_t)
        return
    np.testing.assert_allclose(scale, want_s, rtol=1e-6)
    bound = clip * np.std(x.astype(np.float64))
    p = np.abs(np.clip(x.astype(np.float64), -bound, bound)) / float(want_s[0])
    keep = np.abs(u.numpy() - p) > 1e-5
    assert keep.mean() > 0.99 and (np.abs(x) > bound).any()  # the clip bites
    np.testing.assert_array_equal(tern[keep], want_t[keep])


def test_sparsifier_routes_book_their_payloads():
    """A 1000-element bucket: ``topk`` (k = 10) books its f32 values, then its
    int32 indices, as all-gathers in payload order; ``threshold`` books one
    psum of its f32 dense leaf (its ``nnz`` is not sent), as the reference's
    ``_aggregate_one`` does."""
    bufs = [torch.from_numpy(_vmap_inputs(0)[0])]
    want = {"topk": [("all_gather", 40, "f32"), ("all_gather", 40, "int32")],
            "threshold": [("psum", 4000, "f32")]}
    for name, recs in want.items():
        comm = CommConfig(compressor=name)
        plan = aggregate.make_bucket_plan(comm, {"a": torch.empty(1000)})
        with comms.capture() as log:
            aggregate.aggregate_buckets(comm, plan, bufs,
                                        aggregate.init_comm_state(comm, plan, W, "cpu"),
                                        _key_noise)
        assert [(r.kind, r.payload_bytes, r.wire_format) for r in log.records] == recs


def test_mixed_compressed_plan_books_each_route():
    """QSGD on the compressed wire with a top-k rule on ``embed``: the QSGD
    buckets book their int8 codes and f32 norm, the top-k bucket (k = 90
    of 9000) its f32 values and int32 indices, each at the reference's
    ``CollRecord`` wire bytes for n = W."""
    comm = CommConfig(wire_format="compressed", error_feedback=True,
                      per_tensor_rules=[("embed", "topk", {})], **QSGD)
    plan = aggregate.make_bucket_plan(comm, {k: torch.empty(s) for k, s in MIXED_SHAPES.items()})
    assert [aggregate.bucket_route(comm, plan.compressor(b)) for b in plan.buckets] == [
        "fused_ef", "fused_ef", "fused_ef", "gather"]
    bufs = [torch.from_numpy(b) for b in _round_inputs(0)]
    with comms.capture() as log:
        aggregate.aggregate_buckets(comm, plan, bufs, aggregate.init_comm_state(comm, plan, W, "cpu"),
                                    _noise)
    want = []
    for b in plan.buckets[:3]:
        want += [jcomms.CollRecord("all_gather", ("data",), b.size, 1.0, W, "grad_agg", "int8"),
                 jcomms.CollRecord("all_gather", ("data",), 4, 1.0, W, "grad_agg", "f32")]
    want += [jcomms.CollRecord("all_gather", ("data",), 360, 1.0, W, "grad_agg", "f32"),
             jcomms.CollRecord("all_gather", ("data",), 360, 1.0, W, "grad_agg", "int32")]
    assert _records(log) == [(r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format)
                             for r in want]
    assert [r.wire_bytes for r in log.records] == [r.wire_bytes for r in want]


def test_gtopk_resparsifies_the_mean():
    """gTop-k's aggregate is the top-k workers' mean cut to its own k largest
    magnitudes (ties to the lower index); every worker sends k = 50 of 1000,
    so the mean has up to 200 non-zeros before the cut."""
    bufs = [torch.from_numpy(_vmap_inputs(0, bf16=True)[0])]
    aggs = {}
    for name in ("topk", "gtopk"):
        comm = CommConfig(compressor=name, compressor_kwargs={"ratio": 0.05})
        plan = aggregate.make_bucket_plan(comm, {"a": torch.empty(1000)})
        aggs[name], _ = aggregate.aggregate_buckets(
            comm, plan, bufs, aggregate.init_comm_state(comm, plan, W, "cpu"), _key_noise)
    mean, cut = aggs["topk"][0], aggs["gtopk"][0]
    assert int((mean != 0).sum()) > 50
    idx = np.asarray(jax.lax.top_k(jnp.asarray(mean.abs().numpy()), 50)[1])
    want = np.zeros(1000, np.float32)
    want[idx] = mean.numpy()[idx]
    np.testing.assert_array_equal(cut.numpy(), want)


@pytest.mark.parametrize("impl", ["ring", "rhd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_workers", [3, 8])
def test_collectives_match_reference_under_vmap(impl, dtype, n_workers):
    """The ring and recursive halving-doubling schedules on a (W, n) stack
    against the reference's ``collectives.allreduce`` under ``jax.vmap``,
    at W = 3 and 8 and n = 1003 (padded to a multiple of W): bitwise, each
    hop associated as the reference's, bf16 rounded after every hop; every
    hop booked as the reference's ppermute.  rhd refuses W = 3, as the
    reference does."""
    from repro.core import collectives as jcollectives
    from repro_torch.core import collectives

    rng = np.random.default_rng(n_workers)
    x = (rng.standard_normal((n_workers, 1003))
         * np.logspace(-3, 1, n_workers)[:, None]).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    stack = torch.zeros((n_workers, collectives.padded_len(1003, n_workers)), dtype=tdt)
    stack[:, :1003] = torch.from_numpy(x)
    if impl == "rhd" and n_workers == 3:
        with pytest.raises(ValueError, match="power-of-two"):
            collectives.allreduce(stack, 1003, impl)
        return
    run = jax.vmap(lambda a: jcollectives.allreduce(a, ("data",), impl=impl), axis_name="data")
    with comms.capture() as log:
        got = collectives.allreduce(stack, 1003, impl)
    with jcomms.capture() as jlog:
        want = np.asarray(run(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    assert (want == want[0]).all()
    np.testing.assert_array_equal(got.float().numpy(), want[0])
    assert _records(log) == _records(jlog)
    psum = jcomms.CollRecord("psum", ("data",), 1003 * stack.element_size(), 1.0, n_workers)
    assert log.total_bytes() == pytest.approx(psum.wire_bytes, rel=3 * n_workers / 1003)
