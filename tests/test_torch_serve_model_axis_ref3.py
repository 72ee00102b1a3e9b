"""Serving on the model axis against the reference's ``build_serve`` on a
1 x 2 mesh, as test_torch_serve_model_axis_ref.py holds the dense
families: hymba-1.5b with 5 query heads over one KV head (padded to 6 over
the 2 shards, the KV replicated: only the 5 real heads read the ring, as
the full model's 25 heads padded to 26 over 5 KV heads), qwen2-vl-2b (the
patches, M-RoPE) and seamless-m4t-large-v2 (the encoder's output in the
cache, cross-attention each step), from one 2-device subprocess."""

import pytest

from test_torch_serve_model_axis_ref import run_reference, serve_matches_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ARCHS = {"hymba-1.5b": {"n_heads": 5, "n_kv_heads": 1, "d_model": 5 * 32, "head_dim": 32},
         "qwen2-vl-2b": {}, "seamless-m4t-large-v2": {}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_model_axis_ref3")
    return out, run_reference(ARCHS, out)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_reference(arch, reference):
    out, ref = reference
    serve_matches_reference(arch, ARCHS[arch], out, ref["archs"][arch])
