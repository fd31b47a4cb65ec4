"""Architecture registry of the port: every arch of ``repro/configs``
(dense, MoE, SSM, hybrid, the enc-dec SeamlessM4T and the VLM Phi-3-vision),
in the reference's order.  Each module exposes
``config()`` (published dims) and ``smoke()`` (a reduced same-family
variant for CPU tests).  ``long_context_variant`` is the reference's
sliding-window variant.  The reference's ``supports_long_decode`` /
``supports_shape`` and ``INPUT_SHAPES`` serve its dry-run tooling, which
is not ported yet (ROADMAP.md Queue A item 7f)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import AttnCfg, ModelConfig, config_from_dict

ARCH_IDS = [
    "qwen3_8b",
    "seamless_m4t_large_v2",
    "llama4_scout_17b_a16e",
    "zamba2_1p2b",
    "phi3_vision_4p2b",
    "rwkv6_1p6b",
    "qwen1p5_0p5b",
    "kimi_k2_1t_a32b",
    "nemotron_4_340b",
    "qwen2_1p5b",
    # the paper's own table models
    "qwen3_32b",
    "qwen3_30b_a3b",
    "qwen3p5_gdn_2b",
]


def _canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "p")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    name = _canon(arch)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r} (known: {ARCH_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke() if smoke else mod.config()


def long_context_variant(cfg: ModelConfig, window: int = 8192) -> ModelConfig:
    """Sub-quadratic variant for long decodes: sliding-window attention for
    the full-attention layers (the reference's ``configs/__init__.py:60``).
    A windowed session prefills through the step loop, as the reference's
    does."""
    if cfg.attn is None:
        return cfg
    return cfg.replace(attn=dataclasses.replace(cfg.attn, window=window))
