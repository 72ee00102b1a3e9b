"""Serving on the model axis against the reference's ``build_serve`` on a
1 x 2 mesh, as test_torch_serve_model_axis_ref.py holds the dense
families: qwen3-moe-30b-a3b (2 of 4 experts a shard, the decode's capacity
from the B tokens), deepseek-v2-lite-16b (MLA's latent decode over the
sequence-sharded ring, its dense layer 0, shared experts) and rwkv6-3b (its
heads split over the shards), from one 2-device subprocess."""

import pytest

from test_torch_serve_model_axis_ref import run_reference, serve_matches_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ARCHS = {"qwen3-moe-30b-a3b": {}, "deepseek-v2-lite-16b": {}, "rwkv6-3b": {}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_model_axis_ref2")
    return out, run_reference(ARCHS, out)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_reference(arch, reference):
    out, ref = reference
    serve_matches_reference(arch, ARCHS[arch], out, ref["archs"][arch])
