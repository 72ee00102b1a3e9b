"""Churn on the port's gossip step (D-PSGD and CHOCO-SGD masked over the
ring) and PowerSGD's masked factor psums, against the JAX package's trainer
with the harness of test_torch_churn_trainer.py (losses rtol 1e-4, wire by
tag equal, churn tallies exact):

* CHOCO-SGD over ``qsgd`` 16 under 50% dropout (window steps 1-3) with both
  rejoin policies: the mirror freeze, the rejoiner's snap and its dense
  resync booked under ``churn_resync``;
* D-PSGD under 50% dropout with ``pull_avg``;
* PowerSGD rank 2 with EF under 50% dropout;
* ``dpsgd_mix`` (both rejoin policies) and ``choco_mix`` (a dead worker,
  then a rejoiner) with ``alive`` and ``rejoined`` against the reference's
  under ``jax.vmap(axis_name="data")``: values within rtol 1e-6, the
  booked records equal (the neighbours' bits, the resync channel).
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
from repro_torch.core import comms, gossip
from repro_torch.core.compression import get_compressor
from repro_torch.core.types import CommConfig
from test_torch_churn_trainer import REFERENCE, _one_thread, assert_matches, run_cell  # noqa: F401
from test_torch_gossip import SIZES, W, _bufs
from test_torch_sync import reference_in_subprocess

WINDOW = dict(dropout_rate=0.5, churn_start=1, churn_end=4)
CHOCO = dict(aggregator="gossip", gossip_compress="choco", compressor="qsgd",
             compressor_kwargs={"levels": 16})
CELLS = {
    "choco_reset": (dict(**CHOCO, **WINDOW), 1, 1),
    "choco_pull": (dict(**CHOCO, **WINDOW, rejoin_policy="pull_avg"), 1, 1),
    "dpsgd_pull": (dict(aggregator="gossip", **WINDOW, rejoin_policy="pull_avg"), 1, 1),
    "powersgd": (dict(compressor="powersgd", compressor_kwargs={"rank": 2},
                      error_feedback=True, **WINDOW), 1, 1),
}


@pytest.fixture(scope="module")
def reference():
    return reference_in_subprocess(REFERENCE, CELLS)


@pytest.mark.parametrize("name", list(CELLS))
def test_gossip_churn_cell_matches_reference(name, reference):
    assert_matches(name, reference[name], run_cell(name, CELLS))


def test_choco_rejoin_books_the_resync_channel(reference):
    bundle = run_cell("choco_pull", CELLS, steps=0)[0]
    by_tag = bundle.wire["gossip"]
    assert by_tag["churn_resync"] > 0
    # the formats leave the resync channel out, as the reference's do
    assert sum(bundle.wire["gossip_formats"].values()) == pytest.approx(
        sum(v for k, v in by_tag.items() if k != "churn_resync"))


# ---------------------------------------------------------------------------
# The masked mixes against the reference's under jax.vmap.
# ---------------------------------------------------------------------------

ALIVE = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
REJOINED = np.array([0.0, 0.0, 1.0, 0.0], np.float32)


def _records(log):
    return [(r.kind, r.payload_bytes, r.n_workers, r.tag, r.wire_format) for r in log.records]


@pytest.mark.parametrize("pull", [False, True], ids=["reset", "pull_avg"])
def test_masked_dpsgd_mix_matches_reference_under_vmap(pull):
    bufs = _bufs(3)
    r = jnp.asarray(REJOINED) if pull else None
    run = jax.jit(jax.vmap(
        lambda b, a, rj: jgossip.dpsgd_mix(b, ("data",), w=jnp.float32(1 / 3), alive=a,
                                           rejoined=rj if pull else None),
        axis_name="data"))
    with jcomms.capture() as jlog:
        want = run([jnp.asarray(b) for b in bufs], jnp.asarray(ALIVE), jnp.asarray(REJOINED))
    with comms.capture() as log:
        got = gossip.dpsgd_mix([torch.from_numpy(b) for b in bufs], alive=torch.tensor(ALIVE),
                               rejoined=torch.tensor(REJOINED) if r is not None else None)
    assert _records(log) == _records(jlog)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got[0][1], torch.from_numpy(bufs[0][1]), rtol=0, atol=0)


def test_masked_choco_mix_matches_reference_under_vmap():
    """Two rounds: a dead worker, then a rejoiner whose mirror snaps and
    resyncs (booked under churn_resync)."""
    name, kw = "qsgd", {"levels": 16}
    comm = CommConfig(aggregator="gossip", gossip_compress="choco", compressor=name,
                      compressor_kwargs=kw)
    jcomm = JCommConfig(aggregator="gossip", gossip_compress="choco", compressor=name,
                        compressor_kwargs=kw)
    comp, jcomp = get_compressor(name, **kw), jget_compressor(name, **kw)
    jkn = [{"levels": jnp.float32(16)} for _ in SIZES]

    def jround(bufs, xh, xn, a, rj, key):
        new, st = jgossip.choco_mix(jcomm, jcomp, key, bufs, jgossip.ChocoState(xh, xn),
                                    ("data",), w=jnp.float32(1 / 3), gamma=jnp.float32(0.5),
                                    comp_knobs=jkn, alive=a, rejoined=rj)
        return new, st.x_hat, st.x_hat_nbr

    run = jax.jit(jax.vmap(jround, axis_name="data", in_axes=(0, 0, 0, 0, 0, None)))
    st = gossip.choco_init([torch.zeros(W, n) for n in SIZES])
    jxh = [jnp.zeros((W, n)) for n in SIZES]
    jxn = [jnp.zeros((W, n)) for n in SIZES]
    for round_, (alive, rej) in enumerate(((np.array([1, 0, 1, 1], np.float32), np.zeros(4)),
                                           (np.ones(4, np.float32), REJOINED))):
        rej = rej.astype(np.float32)
        bufs = _bufs(round_)
        key = jax.random.key(round_)

        def noise(i, n, key=key):
            return torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, i),
                                                                (n,))))

        with comms.capture() as log:
            got, st = gossip.choco_mix(comm, comp, noise, [torch.from_numpy(b) for b in bufs],
                                       st, comp_knobs=({"levels": 16.0},) * len(SIZES),
                                       alive=torch.tensor(alive), rejoined=torch.tensor(rej))
        with jcomms.capture() as jlog:
            want, jxh, jxn = run([jnp.asarray(b) for b in bufs], jxh, jxn, jnp.asarray(alive),
                                 jnp.asarray(rej), key)
        if round_ == 0:
            assert _records(log) == _records(jlog)
            assert any(r.tag == "churn_resync" for r in log.records)
        for g, w in zip(got + st.x_hat + st.x_hat_nbr, list(want) + list(jxh) + list(jxn)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
