"""Zamba2-1.2B [arXiv:2411.15242] — hybrid: 38 Mamba2 blocks + one shared
full-attention block applied every 6 layers with [hidden ; embed]
concatenation.  A copy of ``repro/configs/zamba2_1p2b.py``."""
from repro_torch.configs.base import AttnCfg, HybridCfg, ModelConfig, SSMCfg


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, d_ff=8192, vocab_size=32000,
        attn=AttnCfg(n_heads=32, n_kv_heads=32, head_dim=64),
        ssm=SSMCfg(kind="mamba2", d_state=64, head_dim=64, expand=2,
                   conv_kernel=4, chunk_size=64),
        hybrid=HybridCfg(attn_every=6, concat_embed=True),
        mlp_activation="swiglu",
        source="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, d_ff=128, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=4, head_dim=16),
        ssm=SSMCfg(kind="mamba2", d_state=8, head_dim=16, expand=2,
                   conv_kernel=4, chunk_size=8),
        hybrid=HybridCfg(attn_every=2, concat_embed=True),
        dtype="float32", vocab_pad_multiple=8, name="zamba2-smoke")
