"""``seq_par`` training under the model axis: glm4-9b ``reduced()`` with
``seq_par`` (the attention weights replicated and unpadded) at model-axis
size 2 against the reference's ``value_and_grad`` under ``shard_map`` with
``_fix_model_grads``, in one 2-device subprocess, at
test_torch_model_axis_ref.py's tolerances: the loss, ``ce`` and ``aux``
within rtol 1e-5, every gradient within rtol 1e-4 / atol 1e-6 x max, the
booked records equal (the reference's attention masks every head of shard
1, whose global ids pass ``n_heads``, so shard 0 computes the whole
attention and the psum adds it once).  Then the trainer at data 2 x model
2 takes two steps of it."""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.types import CommConfig
from repro_torch.data.pipeline import SyntheticBatches
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import momentum_sgd
from repro_torch.train.steps import build_bundle
from repro_torch.utils.tree import leaves
from test_torch_model_axis_ref import check_against_reference, run_reference
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)

ARCHS = {"glm4-9b": {"seq_par": True}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("seqpar_train_ref")
    return out, run_reference(ARCHS, out)


def test_seqpar_loss_and_grads_match_shard_map(reference):
    out, ref = reference
    check_against_reference("glm4-9b", ARCHS["glm4-9b"], out, ref["glm4-9b"])


def test_seqpar_trains_under_the_model_axis():
    cfg = get_config("glm4-9b").reduced().with_updates(seq_par=True)
    shape = InputShape("t", 16, 4, "train")
    bundle = build_bundle(cfg, CommConfig(), momentum_sgd(0.9), shape, n_workers=2,
                          device="cpu", model=2, cache=False)
    state = bundle.init_state(T.init_params(cfg, 0, "cpu", 2))
    data = SyntheticBatches(cfg, shape, seed=0)
    for t in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(t).items()}
        state, m = bundle.train_step(state, batch, 0.1)
        assert bool(torch.isfinite(m["loss"]).all()), t
    # the replicated attention leaves take the fix-up psum beside the norms
    attn = [r for r in bundle.logs["train"].records if r.tag == "tp_grad_fixup"]
    assert len(attn) == sum(d.shard is None for d in leaves(T.param_defs(cfg, 2)))
