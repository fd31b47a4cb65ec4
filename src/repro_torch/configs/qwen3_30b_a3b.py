"""Qwen3-30B-A3B [arXiv:2505.09388] — the paper's MoE experiment model
(Fig. 7 left): 48L, d_model 2048, 32H/4KV, 128 experts top-8,
d_expert 768.  A copy of ``repro/configs/qwen3_30b_a3b.py``."""
from repro_torch.configs.base import AttnCfg, ModelConfig, MoECfg


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-30b-a3b", family="moe",
        n_layers=48, d_model=2048, d_ff=6144, vocab_size=151936,
        attn=AttnCfg(n_heads=32, n_kv_heads=4, head_dim=128, qk_norm=True,
                     rope_theta=1e6),
        moe=MoECfg(num_experts=128, top_k=8, d_expert=768,
                   capacity_factor=1.25),
        mlp_activation="swiglu",
        source="arXiv:2505.09388 (paper Fig. 7)",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True),
        moe=MoECfg(num_experts=4, top_k=2, d_expert=32,
                   capacity_factor=2.0),
        dtype="float32", vocab_pad_multiple=8, name="qwen3-moe-smoke")
