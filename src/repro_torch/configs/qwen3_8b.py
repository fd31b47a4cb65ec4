"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense, GQA (32H/8KV, head_dim 128),
qk_norm, SwiGLU.
A copy of ``repro/configs/qwen3_8b.py``."""
from repro_torch.configs.base import AttnCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        n_layers=36, d_model=4096, d_ff=12288, vocab_size=151936,
        attn=AttnCfg(n_heads=32, n_kv_heads=8, head_dim=128, qk_norm=True,
                     rope_theta=1e6),
        mlp_activation="swiglu",
        source="hf:Qwen/Qwen3-8B",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, d_ff=256, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=32, qk_norm=True),
        dtype="float32", vocab_pad_multiple=8, name="qwen3-8b-smoke")
