"""The port's twins of the reference's benchmarks (``benchmarks/``): one
module per paper table or figure, each asserting its table's claims and
writing its own ``BENCH_torch_*.json``; ``python -m
repro_torch.benchmarks.run`` runs them under the reference's tags."""
