"""Local SGD (H 2), D-PSGD and CHOCO-SGD gossip (qsgd 16 levels, lr 0.01)
on data 4 x model 2 against the reference's ``Trainer``, as
test_torch_model_axis_trainer.py holds the BSP cells: each shard's local
leaves averaged or mixed over the data axis, shard by shard; losses within
rtol 1e-4 (CHOCO's last step within 2e-3: the reference's replicated
leaves part across its model shards under the compressed exchange, the
port holds shard 0's), the booked wire of the programs the run calls by
(tag, axes) equal to the reference's to the byte; one 8-device
subprocess."""

import numpy as np
import pytest

from test_torch_model_axis_trainer import D, M, check_cell, run_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

#: (CommConfig fields, lr) of each cell; 4 steps
CELLS = {
    "local": (dict(sync="local", local_steps=2), 0.05),
    "dpsgd": (dict(aggregator="gossip"), 0.05),
    "choco": (dict(aggregator="gossip", gossip_compress="choco", compressor="qsgd",
                   compressor_kwargs={"levels": 16}), 0.01),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("model_axis_sync") / "params.npz"
    return run_reference(CELLS, D, M, path), dict(np.load(path))


@pytest.mark.parametrize("name", list(CELLS))
def test_sync_and_gossip_on_model_axis_match_reference(name, reference):
    ref, flat = reference
    check_cell(name, *CELLS[name], ref, flat)
