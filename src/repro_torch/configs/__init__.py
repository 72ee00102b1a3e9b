"""Architecture registry of the port: the dense GQA family and its variants
(partial RoPE, qkv bias, sliding windows), the MoE family with and without
MLA, RWKV6, the hybrid attention + Mamba family (hymba), the vision family
(qwen2-vl: M-RoPE and patch embeddings) and the audio encoder-decoder
(seamless)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

ARCHS = ("qwen3-0.6b", "rwkv6-3b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "glm4-9b",
         "qwen1.5-32b", "gemma3-12b", "hymba-1.5b", "qwen2-vl-2b", "seamless-m4t-large-v2")


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported so far: {ARCHS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.get_config()


def list_archs() -> tuple[str, ...]:
    return ARCHS
