"""The port's twins of the reference's benchmarks (``benchmarks/``):
``python -m repro_torch.benchmarks.train_micro`` and
``python -m repro_torch.benchmarks.overlap_bench``, each writing its own
``BENCH_torch_*.json``."""
