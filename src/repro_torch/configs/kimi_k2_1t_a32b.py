"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-parameter MoE: 61 layers
(first dense), 384 routed experts top-8 + 1 shared, d_expert 2048,
d_model 7168, 64 q heads (GQA kv=8).  Paper-table scale model.
A copy of ``repro/configs/kimi_k2_1t_a32b.py``."""
from repro_torch.configs.base import AttnCfg, ModelConfig, MoECfg


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, d_ff=18432, vocab_size=163840,
        attn=AttnCfg(n_heads=64, n_kv_heads=8, head_dim=128),
        moe=MoECfg(num_experts=384, top_k=8, d_expert=2048,
                   num_shared_experts=1, first_dense_layers=1,
                   capacity_factor=1.25),
        mlp_activation="swiglu",
        source="arXiv:2501.kimi2",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16),
        moe=MoECfg(num_experts=4, top_k=2, d_expert=32,
                   num_shared_experts=1, first_dense_layers=1,
                   capacity_factor=2.0),
        dtype="float32", vocab_pad_multiple=8, name="kimi-smoke")
