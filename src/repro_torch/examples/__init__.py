"""The port's twins of the reference's comparison examples (``examples/``),
each run as ``python -m repro_torch.examples.<name> [--device cpu]``."""
