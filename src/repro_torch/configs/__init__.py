"""Architecture registry of the port: the archs copied from
``repro/configs`` so far.  Each module exposes ``config()`` (published
dims) and ``smoke()`` (a reduced same-family variant for CPU tests)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import AttnCfg, ModelConfig, config_from_dict

ARCH_IDS = ["qwen1p5_0p5b", "qwen2_1p5b", "qwen3_30b_a3b"]


def _canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "p")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    name = _canon(arch)
    if name not in ARCH_IDS:
        raise KeyError(f"{arch!r} is not ported yet (ported: {ARCH_IDS}); "
                       f"see ROADMAP.md Queue A")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke() if smoke else mod.config()
