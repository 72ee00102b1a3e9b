"""The compression_comparison twin's last 4 cells (signSGD majority, top-k
and gTop-k with error feedback, local SGD) on data 4 x model 2 against the reference's, at 3 steps, as
test_torch_model_axis_examples.py holds the first 4: final losses within
rtol 1e-4, the wire per step equal; one 8-device subprocess."""

import pytest

from test_torch_model_axis_examples import check_cells, run_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

PART = slice(4, None)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("model_axis_examples2") / "params.npz", PART,
                         quick=False)


def test_compression_comparison_cells_match_reference(reference):
    check_cells(PART, *reference)
