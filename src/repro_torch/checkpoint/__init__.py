from repro_torch.checkpoint.ckpt import restore, save  # noqa: F401
