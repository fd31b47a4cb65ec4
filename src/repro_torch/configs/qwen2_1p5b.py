"""Qwen2-1.5B [arXiv:2407.10671] — dense, GQA 12H/2KV, QKV bias.
A copy of ``repro/configs/qwen2_1p5b.py``."""
from repro_torch.configs.base import AttnCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, d_ff=8960, vocab_size=151936,
        attn=AttnCfg(n_heads=12, n_kv_heads=2, head_dim=128,
                     qkv_bias=True),
        mlp_activation="swiglu",
        source="arXiv:2407.10671",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=96, d_ff=192, vocab_size=512,
        attn=AttnCfg(n_heads=6, n_kv_heads=2, head_dim=16, qkv_bias=True),
        dtype="float32", vocab_pad_multiple=8, name="qwen2-smoke")
