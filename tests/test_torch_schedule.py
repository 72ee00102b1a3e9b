"""The §VII cost and schedule models in the port (``repro_torch.core.costmodel``
and ``repro_torch.core.schedule``, plain Python) against the JAX package's:
every Table III algorithm, the PS and gossip costs, the round wire bytes
and Table IV's upload bits on a grid, and ``simulate_schedule`` in every
mode (sequential, WFBP, MG-WFBP, pipelined at staleness 0 and 1) on the
cells of ``tests/test_overlap.py::test_simulate_schedule_pipelined_mode``
and a small grid: equal results, to the last bit (the same arithmetic in
the same order).
"""

import pytest

from repro.core import costmodel as jcost
from repro.core import schedule as jsched
from repro_torch.core import costmodel, schedule

LINKS = [(1e-5, 1.0 / 50e9), (5e-4, 1e-9)]


@pytest.mark.parametrize("alg", jcost.TABLE_III_ALGS)
@pytest.mark.parametrize("n", [1, 2, 4, 16, 64])
def test_allreduce_cost_matches_reference(alg, n):
    assert costmodel.TABLE_III_ALGS == jcost.TABLE_III_ALGS
    for a, b in LINKS:
        for nbytes in (4e3, 4e6, 2.4e9):
            assert costmodel.allreduce_cost(alg, n, nbytes, costmodel.Link(a, b)) == \
                jcost.allreduce_cost(alg, n, nbytes, jcost.Link(a, b))


def test_unknown_allreduce_raises_alike():
    for mod in (costmodel, jcost):
        with pytest.raises(ValueError):
            mod.allreduce_cost("butterfly", 4, 1e6)


@pytest.mark.parametrize("n", [2, 8, 32])
def test_ps_gossip_and_round_bytes_match_reference(n):
    for a, b in LINKS:
        for nbytes in (1e3, 1e7):
            for congested in (True, False):
                assert costmodel.ps_cost(n, nbytes, costmodel.Link(a, b), congested=congested) \
                    == jcost.ps_cost(n, nbytes, jcost.Link(a, b), congested=congested)
            for peers in (1, 2, 4):
                assert costmodel.gossip_cost(nbytes, peers, costmodel.Link(a, b)) == \
                    jcost.gossip_cost(nbytes, peers, jcost.Link(a, b))
                for arch in ("ps", "allreduce", "gossip"):
                    assert costmodel.round_wire_bytes(arch, n, nbytes, peers=peers) == \
                        jcost.round_wire_bytes(arch, n, nbytes, peers=peers)
    with pytest.raises(ValueError):
        costmodel.round_wire_bytes("mesh", n, 1.0)


@pytest.mark.parametrize("compress", ["none", "quant", "spars"])
def test_upload_bits_match_reference(compress):
    for N in (1, 1000, 596_049_920):
        for kw in (dict(), dict(ratio=0.001, levels=4, T=8, T_comm=4), dict(n_workers=4, T=3)):
            assert costmodel.upload_bits(compress, N, **kw) == \
                jcost.upload_bits(compress, N, **kw)
    with pytest.raises(ValueError):
        costmodel.upload_bits("sketch", 10)


def _layers(mod, n, grad_bytes, bwd):
    return [mod.LayerSpec(f"l{i}", grad_bytes=grad_bytes * (1 + i % 3), backward_time=bwd)
            for i in range(n)]


#: (mode, staleness, bucket_bytes) of every schedule
MODES = [("sequential", 1, 0.0), ("wfbp", 1, 0.0), ("mgwfbp", 1, 16e6), ("mgwfbp", 1, 0.0),
         ("pipelined", 1, 0.0), ("pipelined", 0, 0.0), ("pipelined", 1, 16e6),
         ("pipelined", 0, 16e6)]


@pytest.mark.parametrize("mode,staleness,bucket_bytes", MODES)
def test_simulate_schedule_matches_reference(mode, staleness, bucket_bytes):
    for a, b in LINKS:
        for n_layers, grad_bytes, bwd in ((16, 4e6, 1e-3), (5, 1e5, 2e-4), (28, 2.4e7, 5e-3)):
            for n_workers, alg, launch in ((16, "ring", 0.0), (4, "rhd", 3e-5),
                                           (8, "hierarchical", 0.0)):
                kw = dict(n_workers=n_workers, alg=alg, mode=mode, staleness=staleness,
                          bucket_bytes=bucket_bytes, launch=launch)
                got = schedule.simulate_schedule(_layers(schedule, n_layers, grad_bytes, bwd),
                                                 link=costmodel.Link(a, b), **kw)
                want = jsched.simulate_schedule(_layers(jsched, n_layers, grad_bytes, bwd),
                                                link=jcost.Link(a, b), **kw)
                assert got == want


def test_simulate_schedule_pipelined_cells_of_the_reference_test():
    """The cells of the reference's pipelined-mode test, with its claims."""
    link = costmodel.Link(alpha=5e-4, beta=1e-9)
    layers = [schedule.LayerSpec(f"l{i}", grad_bytes=4e6, backward_time=1e-3)
              for i in range(16)]
    jlayers = [jsched.LayerSpec(f"l{i}", grad_bytes=4e6, backward_time=1e-3)
               for i in range(16)]
    kw = dict(n_workers=16, alg="ring")
    runs = {}
    for mode, st, bb in [("sequential", 1, 0.0), ("wfbp", 1, 0.0), ("pipelined", 1, 0.0),
                         ("pipelined", 0, 0.0), ("pipelined", 1, 16e6)]:
        runs[(mode, st, bb)] = schedule.simulate_schedule(
            layers, link=link, mode=mode, staleness=st, bucket_bytes=bb, **kw)
        assert runs[(mode, st, bb)] == jsched.simulate_schedule(
            jlayers, link=jcost.Link(alpha=5e-4, beta=1e-9), mode=mode, staleness=st,
            bucket_bytes=bb, **kw)
    seq, wfbp = runs[("sequential", 1, 0.0)], runs[("wfbp", 1, 0.0)]
    p1, p0 = runs[("pipelined", 1, 0.0)], runs[("pipelined", 0, 0.0)]
    assert seq["overlap_saving"] == pytest.approx(0.0)
    assert p1["iter_time"] == pytest.approx(max(p1["bwd_time"], p1["total_comm_time"]))
    assert p1["iter_time"] <= p0["iter_time"] + 1e-12 <= wfbp["iter_time"] + 2e-12
    assert runs[("pipelined", 1, 16e6)]["n_messages"] < p1["n_messages"]
    with pytest.raises(ValueError):
        schedule.simulate_schedule(layers, mode="async", **kw)
