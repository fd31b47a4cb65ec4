"""RWKV6 "Finch" 1.6B [arXiv:2404.05892] — attention-free; data-dependent
per-channel decay time-mix + channel-mix; token shift everywhere.
A copy of ``repro/configs/rwkv6_1p6b.py``."""
from repro_torch.configs.base import ModelConfig, SSMCfg


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, d_ff=7168, vocab_size=65536,
        ssm=SSMCfg(kind="rwkv6", head_dim=64, expand=1, chunk_size=32),
        source="arXiv:2404.05892",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, d_ff=128, vocab_size=512,
        ssm=SSMCfg(kind="rwkv6", head_dim=16, expand=1, chunk_size=8),
        dtype="float32", vocab_pad_multiple=8, name="rwkv6-smoke")
