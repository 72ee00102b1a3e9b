"""Architecture registry of the port: the dense GQA family and its variants
(partial RoPE, qkv bias, sliding windows), the MoE family with and without
MLA, and RWKV6."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

ARCHS = ("qwen3-0.6b", "rwkv6-3b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "glm4-9b",
         "qwen1.5-32b", "gemma3-12b")


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported so far: {ARCHS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.get_config()


def list_archs() -> tuple[str, ...]:
    return ARCHS
