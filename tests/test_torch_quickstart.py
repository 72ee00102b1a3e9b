"""The quickstart twin (``repro_torch/examples/quickstart.py``) at its own
tiny size on the CPU: 200 steps of top-k (5%) with error feedback and
momentum correction over 4 stacked workers, the loss below 0.8 x its first
(the example's own assertion), then the trained model served through
``build_serve`` at model-axis size 2 (the reference's 4 x 2 mesh): 16
greedy tokens per sequence, each in the vocabulary."""

from repro_torch.examples import quickstart
from test_torch_sync import _one_thread  # noqa: F401  (torch on one thread)


def test_quickstart_trains_then_serves(capsys):
    gen = quickstart.main(["--device", "cpu"])
    assert tuple(gen.shape) == (4, 16)
    assert 0 <= int(gen.min()) and int(gen.max()) < 128
    out = capsys.readouterr().out
    assert out.rstrip().endswith("QUICKSTART OK")
