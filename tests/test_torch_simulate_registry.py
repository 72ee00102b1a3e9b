"""Every registered compressor of the port through its convergence engine,
on BSP with error feedback, against the JAX package's engine with the same
draws (test_torch_simulate.py's tolerances): the claim is the whole
registry, as tests/test_scan_engine.py makes it for the reference."""

import jax
import numpy as np
import pytest
import torch

from repro.core.compression import get_compressor as jget
from repro.core.compression.base import list_compressors
from repro_torch.core.compression import base as pbase
from repro_torch.core.compression.powersgd import PowerSGD
from test_torch_simulate import engine_matches_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)


def test_the_registries_agree():
    assert pbase.list_compressors() == list_compressors()


@pytest.mark.parametrize("name", list_compressors())
def test_every_registered_compressor_matches_reference(name, monkeypatch):
    if name == "powersgd":
        # the reference's initial Q comes from jax.random.key(7), which torch
        # cannot draw: hand the port the same columns
        def init_q_cols(self, n, seed, device="cpu"):
            q = jget("powersgd", rank=self.rank).init_q(n, jax.random.key(seed))
            return torch.from_numpy(np.array(q)).to(device)

        monkeypatch.setattr(PowerSGD, "init_q_cols", init_q_cols)
    engine_matches_reference("bsp", name, {}, True, steps=8, lr=0.02)


def test_powersgd_rank_envelope():
    """A class of ranks 2 and 4 runs at width 4; the rank-2 cell's masked
    columns give the rank-2 program's result, and its Q0 columns are the
    narrow draw's."""
    wide, narrow = PowerSGD(rank=4), PowerSGD(rank=2)
    rep = pbase.merge_representative([narrow, wide])
    assert rep.rank == 4 and pbase.structural_envelope(rep) == ("rank", 4)
    assert pbase.shape_fingerprint(narrow) == pbase.shape_fingerprint(wide)
    torch.testing.assert_close(rep.init_q_cols(64, 7)[:, :2], narrow.init_q_cols(64, 7),
                               rtol=0, atol=0)
    x = torch.randn(3, 64)
    got, bits = rep.roundtrip_p(None, x, {"rank": torch.full((3,), 2.0)})
    want, want_bits = narrow.roundtrip_p(None, x, {})
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bits, want_bits)
