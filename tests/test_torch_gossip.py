"""Gossip in the port (``repro_torch.core.gossip``, the trainer's
``gossip_step``): D-PSGD and CHOCO-SGD on the ring of workers, against the
JAX package.

* The mixing matrices and the spectral gap equal the reference's.
* One W = 4 mixing round on (W, n) bucket stacks equals the reference's
  ``dpsgd_mix`` and ``choco_mix`` run under ``jax.vmap(axis_name="data")``
  (its ppermutes exchange rows of the vmap axis, its Pallas kernels run in
  interpret mode), over two rounds so the CHOCO mirrors are non-zero:
  ``signsgd_packed``, ``qsgd_kernel`` (16 levels; one dither per bucket that
  every worker shares, as the reference's key folds no worker index) and
  ``topk``; mixed parameters and both mirrors within rtol 1e-6; the booked
  records (kind, payload bytes, tag, format) equal the reference's capture.
* The whole slice: ``Trainer.fit`` at W = 4 on the tiny workload against
  the reference's ``run_trainer_scenario(data_par=4)``, run once for the
  module in a subprocess with four host devices: D-PSGD (lr 0.05) and
  CHOCO-SGD with ``signsgd_packed`` and with ``qsgd_kernel`` (lr 0.01),
  4 steps each: losses within rtol 1e-4, booked ``gossip_mix`` wire per step
  equal to the reference's ``measured["wire_kb_per_step"]``.  CHOCO with
  QSGD diverges in the reference itself (11.55 at step 3): the series stays
  finite over these 4 steps, and the port follows it there.
* ``gossip_compress="dcd"`` and a compressor-less ``"choco"`` run plain
  D-PSGD, as the reference's step does; ``gossip_graph`` is read by
  nothing (the runtime ring is always the ring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comms as jcomms
from repro.core import gossip as jgossip
from repro.core.compression import get_compressor as jget_compressor
from repro.core.types import CommConfig as JCommConfig
from repro_torch.core import aggregate, comms, gossip
from repro_torch.core.compression import get_compressor
from repro_torch.core.types import CommConfig
from repro_torch.kernels import ops
from repro_torch.train.trainer import wire_per_step
from test_torch_sync import _noise, _one_thread, port_run, reference_in_subprocess  # noqa: F401

W = 4
Q = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16})
#: (CommConfig fields, lr) of each whole-slice cell; 4 steps
CELLS = {
    "dpsgd": (dict(aggregator="gossip"), 0.05),
    "choco-signsgd_packed": (dict(aggregator="gossip", gossip_compress="choco",
                                  compressor="signsgd_packed"), 0.01),
    "choco-qsgd_kernel": (dict(aggregator="gossip", gossip_compress="choco", **Q), 0.01),
}

REFERENCE = r"""
import json
from repro.experiments import Scenario
from repro.experiments.trainer_substrate import run_trainer_scenario
CELLS = json.loads('CELLS_JSON')
out = {}
for name, (kw, lr) in CELLS.items():
    kw = dict(kw, arch=kw.pop("aggregator"))
    if "compressor_kwargs" in kw:
        kw["compressor_kwargs"] = tuple(sorted(kw["compressor_kwargs"].items()))
    r = run_trainer_scenario(Scenario(n_workers=4, steps=4, bucket_bytes=4e6, lr=lr, **kw),
                             data_par=4)
    out[name] = {"loss": [float(x) for x in r.series["loss_full"]],
                 "wire_kb": r.measured["wire_kb_per_step"]}
print("REF " + json.dumps(out))
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m gpu` on the H100")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def reference_series():
    """Every cell's reference series and wire, from one 4-device subprocess."""
    return reference_in_subprocess(REFERENCE, CELLS)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_mixing_matrices_match_reference(n):
    for w in (1.0 / 3.0, 0.25):
        np.testing.assert_array_equal(gossip.ring_mixing_matrix(n, w),
                                      jgossip.ring_mixing_matrix(n, w))
    np.testing.assert_array_equal(gossip.exp_mixing_matrix(n), jgossip.exp_mixing_matrix(n))
    m = gossip.ring_mixing_matrix(n)
    assert gossip.spectral_gap(m) == jgossip.spectral_gap(m)
    np.testing.assert_allclose(m.sum(0), 1.0)
    np.testing.assert_allclose(m.sum(1), 1.0)


# ---------------------------------------------------------------------------
# One mixing round at W = 4 against the reference's under jax.vmap.
# ---------------------------------------------------------------------------

SIZES = (1000, 407, 9000)


def _bufs(round_):
    rng = np.random.default_rng(40 + round_)
    return [(rng.standard_normal((W, n)) * 0.1).astype(np.float32) for n in SIZES]


def _records(log):
    return [(r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format) for r in log.records]


def test_dpsgd_mix_matches_reference_under_vmap():
    run = jax.jit(jax.vmap(lambda b: jgossip.dpsgd_mix(b, ("data",), w=jnp.float32(1 / 3)),
                           axis_name="data"))
    bufs = _bufs(0)
    with jcomms.capture() as jlog:
        want = run([jnp.asarray(b) for b in bufs])
    with comms.capture() as log:
        got = gossip.dpsgd_mix([torch.from_numpy(b) for b in bufs])
    assert _records(log) == _records(jlog)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


CHOCO = {"signsgd_packed": {}, "qsgd_kernel": {"levels": 16}, "topk": {"ratio": 0.05}}


@pytest.mark.parametrize("name", list(CHOCO))
def test_choco_mix_matches_reference_under_vmap(name):
    kw = CHOCO[name]
    comm = CommConfig(aggregator="gossip", gossip_compress="choco", compressor=name,
                      compressor_kwargs=kw, gossip_step_size=0.4)
    jcomm = JCommConfig(aggregator="gossip", gossip_compress="choco", compressor=name,
                        compressor_kwargs=kw, gossip_step_size=0.4)
    comp, jcomp = get_compressor(name, **kw), jget_compressor(name, **kw)
    plan = aggregate.make_bucket_plan(comm, {f"b{i}": torch.empty(n) for i, n in enumerate(SIZES)})
    knobs = plan.knob_values()
    jknobs = [{k: jnp.float32(v) for k, v in d.items()} for d in knobs]

    def jround(bufs, xh, xn, key):
        new, st = jgossip.choco_mix(jcomm, jcomp, key, bufs, jgossip.ChocoState(xh, xn),
                                    ("data",), w=jnp.float32(1 / 3), gamma=jnp.float32(0.4),
                                    comp_knobs=jknobs)
        return new, st.x_hat, st.x_hat_nbr

    run = jax.jit(jax.vmap(jround, axis_name="data", in_axes=(0, 0, 0, None)))
    st = gossip.choco_init([torch.zeros(W, n) for n in SIZES])
    jxh = [jnp.zeros((W, n)) for n in SIZES]
    jxn = [jnp.zeros((W, n)) for n in SIZES]
    for round_ in range(2):  # the second round starts from non-zero mirrors
        bufs = _bufs(round_)
        key = jax.random.key(round_)

        def noise(i, n, key=key):
            return torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, i),
                                                                (n,))))

        with comms.capture() as log:
            got, st = gossip.choco_mix(comm, comp, noise, [torch.from_numpy(b) for b in bufs],
                                       st, comp_knobs=knobs)
        with jcomms.capture() as jlog:
            want, jxh, jxn = run([jnp.asarray(b) for b in bufs], jxh, jxn, key)
        if round_ == 0:  # the reference books while tracing, on the first call
            assert _records(log) == _records(jlog)
        for g, w in zip(got + st.x_hat + st.x_hat_nbr, list(want) + list(jxh) + list(jxn)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


# ---------------------------------------------------------------------------
# The whole slice at W = 4 against the reference's trainer.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(CELLS))
def test_gossip_slice_matches_reference_trainer(cell, reference_series):
    kw, lr = CELLS[cell]
    bundle, _, state, losses = port_run(CommConfig(bucket_mb=4.0, **kw), lr=lr)
    want = reference_series[cell]
    np.testing.assert_allclose(losses, want["loss"], rtol=1e-4)
    assert wire_per_step(bundle, 4) / 1e3 == pytest.approx(want["wire_kb"], rel=1e-12)
    assert set(bundle.wire) == {"gossip", "gossip_formats"}
    assert state["comm"]["step"] == state["step"] == 4
    assert ("choco_xhat" in state["comm"]) == (kw.get("gossip_compress") == "choco")


def test_dcd_and_compressorless_choco_run_dpsgd(reference_series):
    """As in the reference's step, gossip_compress "dcd" (with a
    compressor) and "choco" without one mix by plain D-PSGD: both follow
    the reference's D-PSGD series, and equal the port's own bitwise;
    gossip_graph "exp" changes nothing either."""
    runs = [port_run(CommConfig(aggregator="gossip", bucket_mb=4.0, **kw))[3]
            for kw in (dict(), dict(gossip_compress="dcd", **Q), dict(gossip_compress="choco"),
                       dict(gossip_graph="exp"))]
    np.testing.assert_allclose(runs[0], reference_series["dpsgd"]["loss"], rtol=1e-4)
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])


@pytest.mark.gpu
@pytest.mark.parametrize("cell,kernels", [
    ("dpsgd", {}),
    # per step: one compress (and one self-decode) per worker and bucket
    ("choco-signsgd_packed", {"sign_pack": 4 * 2, "sign_unpack": 4 * 2}),
    ("choco-qsgd_kernel", {"qsgd": 4 * 2}),
])
def test_gossip_paths_on_card_launch_their_kernels(cuda, cell, kernels):
    """Each cell at W = 2 on the card, 4 steps, launches exactly its
    kernels (one bucket); the losses stay close to the CPU plain path's
    (other sum orders in the model: rtol 1e-3)."""
    kw, lr = CELLS[cell]
    comm = CommConfig(bucket_mb=4.0, **kw)
    ops.reset_launches()
    _, _, _, on_card = port_run(comm, n_workers=2, lr=lr, device=cuda,
                                noise=lambda *a: _noise(*a).to(cuda))
    assert ops.LAUNCHES == {k: kernels.get(k, 0) for k in ops.LAUNCHES}
    _, _, _, on_cpu = port_run(comm, n_workers=2, lr=lr)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-3)
