"""Qwen3-32B [arXiv:2505.09388] — the paper's dense experiment model
(Fig. 7 right): 64L, d_model 5120, 64H/8KV head_dim 128, qk_norm.
A copy of ``repro/configs/qwen3_32b.py``."""
from repro_torch.configs.base import AttnCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, d_ff=25600, vocab_size=151936,
        attn=AttnCfg(n_heads=64, n_kv_heads=8, head_dim=128, qk_norm=True,
                     rope_theta=1e6),
        mlp_activation="swiglu",
        source="arXiv:2505.09388 (paper Fig. 7)",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, d_ff=256, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=32, qk_norm=True),
        dtype="float32", vocab_pad_multiple=8, name="qwen3-32b-smoke")
