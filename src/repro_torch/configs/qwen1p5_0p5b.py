"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, MHA 16H (kv=16), QKV bias.
A copy of ``repro/configs/qwen1p5_0p5b.py``."""
from repro_torch.configs.base import AttnCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        n_layers=24, d_model=1024, d_ff=2816, vocab_size=151936,
        attn=AttnCfg(n_heads=16, n_kv_heads=16, head_dim=64,
                     qkv_bias=True),
        mlp_activation="swiglu",
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=4, head_dim=16, qkv_bias=True),
        dtype="float32", vocab_pad_multiple=8, name="qwen1.5-smoke")
