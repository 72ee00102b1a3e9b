"""The model axis against the reference's ``shard_map`` for hymba-1.5b
with 5 heads (padded to 6 over 2 shards: a padded head's output zeroed),
qwen2-vl-2b (patches, M-RoPE) and seamless-m4t-large-v2 (the encoder and
cross-attention), as test_torch_model_axis_ref.py holds the others: loss,
``ce``, ``aux``, every gradient and the booked model-axis records at
model-axis size 2, from one 2-device subprocess for the module."""

import pytest

from test_torch_model_axis_ref import check_against_reference, run_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ARCHS = {"hymba-1.5b": {"n_heads": 5, "n_kv_heads": 5, "d_model": 5 * 32, "head_dim": 32},
         "qwen2-vl-2b": {}, "seamless-m4t-large-v2": {}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("model_axis_ref2")
    return out, run_reference(ARCHS, out)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_loss_and_grads_match_shard_map(arch, reference):
    out, ref = reference
    check_against_reference(arch, ARCHS[arch], out, ref[arch])
