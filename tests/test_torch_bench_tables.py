"""The port's paper-table twins (``repro_torch.benchmarks``) against the
reference's modules (``benchmarks/``): Tables III, IV, II / Fig. 4 and
section VII row for row (names, ``derived`` strings and times equal; the
reference's ``run()`` of these writes nothing), the orchestrator's CSV for
those tags, Table IV's payload bytes on the reference's 1M array, and Fig.
6's NMSE per compressor on the reference's array and draws.

Fig. 6's tolerance: rtol 1e-5 on every NMSE (f32 means over 1M elements in
another order), except the stochastic quantizers ``qsgd_s4`` / ``qsgd_s16``,
held to the ROADMAP's parity rule for dithered codes: the codes equal the
reference's except where the dither gap ``|y - floor(y) - u|`` is within
the norm's deviation (y scales by the norm).  At 1M elements torch's f32
norm on the CPU sums in its own order and lands 1.5e-5 from XLA's (which
is within 1e-8 of the f64 norm), so the norm is held to rtol 1e-4, the gap
to 1e-4 and the NMSE, which scales with the norm, to rtol 1e-4.  PowerSGD gets the
reference's initial Q through the compressor's ``q0`` hook.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import get_compressor as jget_compressor
from repro.core.compression.powersgd import PowerSGD as JPowerSGD
from repro_torch.benchmarks import (
    allreduce_table,
    comm_cost_table,
    compression_fidelity,
    schedule_table,
    sync_timeline,
)
from repro_torch.benchmarks import run as prun
from repro_torch.core.compression import get_compressor
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

TABLE_TAGS = "tableIII_allreduce,tableIV_comm_cost,tableII_fig4_sync,sec7_schedule"


def _rows(rows):
    return [(r.name, r.us_per_call, str(r.derived)) for r in rows]


@pytest.mark.parametrize("port, ref", [
    (allreduce_table, "benchmarks.allreduce_table"),
    (sync_timeline, "benchmarks.sync_timeline"),
    (schedule_table, "benchmarks.schedule_table"),
])
def test_table_rows_match_reference(port, ref, tmp_path):
    import importlib

    want = _rows(importlib.import_module(ref).run())
    path = tmp_path / "rec.json"
    got = _rows(port.run("cpu", str(path)))
    assert got == want
    rec = json.loads(path.read_text())
    assert [r["name"] for r in rec["rows"]] == [w[0] for w in want]
    assert rec["device"] == "cpu" and rec["nvidia_smi"] == "not measured"


def test_table_iv_analytic_rows_match_reference():
    from benchmarks import comm_cost_table as ref

    want = [r for r in _rows(ref.run()) if "/payload/" not in r[0]]
    assert _rows(comm_cost_table.analytic_rows()) == want
    assert comm_cost_table.N == ref.N == 25_000_000


def test_table_iv_payload_bytes_on_the_reference_array():
    n = comm_cost_table.BUCKET
    assert n == 1_000_000
    x = jax.random.normal(jax.random.key(0), (n,))
    want = {name: jget_compressor(name, **kw).compress(jax.random.key(1), x).payload_bytes()
            for name, kw in comm_cost_table.FORMATS}

    def noise(name, k):
        return torch.from_numpy(np.array(jax.random.uniform(jax.random.key(1), (k,))))

    assert comm_cost_table.payload_bytes(torch.from_numpy(np.array(x)), noise) == want


def test_orchestrator_csv_matches_reference(tmp_path):
    from benchmarks import run as jrun

    def csv(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        return [ln for ln in buf.getvalue().splitlines() if not ln.startswith("#")]

    want = csv(jrun.main, ["--only", TABLE_TAGS])
    got = csv(prun.main, ["--device", "cpu", "--only", TABLE_TAGS, "--out-dir", str(tmp_path)])
    assert got == want and len(got) == 92
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BENCH_torch_allreduce.json", "BENCH_torch_comm_cost.json", "BENCH_torch_schedule.json",
        "BENCH_torch_sync.json"]
    assert [t for t, _ in prun.MODULES] == [t for t, _ in jrun.MODULES]
    with pytest.raises(SystemExit):
        prun.main(["--only", "tableV"])


@pytest.fixture(scope="module")
def fig6():
    """The reference's Fig. 6 array, its roundtrips on key(3) and NMSE, the
    port's NMSE on the same array and draws (q0: the reference's)."""
    n = compression_fidelity.N
    key = jax.random.key(0)
    g = jax.random.normal(key, (n,)) * 0.01
    spikes = jax.random.normal(jax.random.fold_in(key, 1), (n,)) * 0.1
    mask = jax.random.uniform(jax.random.fold_in(key, 2), (n,)) < 0.01
    x = jnp.where(mask, spikes, g)
    ref, xh_ref = {}, {}
    for tag, name, kw in compression_fidelity.CASES:
        comp = jget_compressor(name, **kw)
        xh = jax.jit(lambda v, k, comp=comp: comp.decompress(comp.compress(k, v)))(
            x, jax.random.key(3))
        xh_ref[tag] = np.asarray(xh)
        ref[tag] = float(jnp.mean(jnp.square(xh - x))) / float(jnp.mean(jnp.square(x)))
    draw = {}

    def noise(tag, k):
        draw[tag] = np.array(jax.random.uniform(jax.random.key(3), (k,)))
        return torch.from_numpy(draw[tag])

    q0 = torch.from_numpy(np.array(JPowerSGD(rank=4).init_q(n, jax.random.key(7))))
    xt = torch.from_numpy(np.array(x))
    got = compression_fidelity.fidelity(xt, noise=noise, q0=q0, timed=False)
    return {"x": np.array(x), "ref": ref, "xh_ref": xh_ref, "got": got, "draw": draw}


QUANTIZED = ("qsgd_s4", "qsgd_s16")


@pytest.mark.parametrize("tag", [c[0] for c in compression_fidelity.CASES
                                 if c[0] not in QUANTIZED])
def test_fig6_nmse_matches_reference(fig6, tag):
    np.testing.assert_allclose(fig6["got"][tag]["nmse"], fig6["ref"][tag], rtol=1e-5)
    name, kw = next((n, kw) for t, n, kw in compression_fidelity.CASES if t == tag)
    comp = jget_compressor(name, **kw)
    want = 32.0 * fig6["x"].size / comp.wire_bits(fig6["x"].size)
    np.testing.assert_allclose(fig6["got"][tag]["ratio"], want, rtol=1e-12)


@pytest.mark.parametrize("tag", QUANTIZED)
def test_fig6_quantizers_flip_only_at_the_dither_boundary(fig6, tag):
    levels = {"qsgd_s4": 4, "qsgd_s16": 16}[tag]
    x, u = fig6["x"], fig6["draw"][tag]
    got = get_compressor("qsgd", levels=levels).compress(torch.from_numpy(u),
                                                         torch.from_numpy(x))
    want = jget_compressor("qsgd", levels=levels).compress(jax.random.key(3), jnp.asarray(x))
    norm = np.asarray(want.payload["norm"])
    np.testing.assert_allclose(got.payload["norm"].numpy(), norm, rtol=1e-4)
    y = np.abs(x.astype(np.float64)) / float(norm[0]) * levels
    keep = np.abs(y - np.floor(y) - u) > 1e-4
    assert keep.mean() > 0.999
    np.testing.assert_array_equal(got.payload["code"].numpy()[keep],
                                  np.asarray(want.payload["code"])[keep])
    np.testing.assert_allclose(fig6["got"][tag]["nmse"], fig6["ref"][tag], rtol=1e-4)
    assert fig6["got"]["qsgd_s16"]["nmse"] < fig6["got"]["qsgd_s4"]["nmse"]
    assert fig6["got"]["topk_1pct"]["nmse"] < fig6["got"]["randomk_1pct"]["nmse"]
