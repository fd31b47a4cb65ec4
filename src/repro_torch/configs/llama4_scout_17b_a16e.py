"""Llama-4 Scout 17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE,
16 experts top-1 + shared expert, every layer MoE, early fusion
(text-only backbone here).
A copy of ``repro/configs/llama4_scout_17b_a16e.py``."""
from repro_torch.configs.base import AttnCfg, ModelConfig, MoECfg


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, d_ff=8192, vocab_size=202048,
        attn=AttnCfg(n_heads=40, n_kv_heads=8, head_dim=128,
                     rope_theta=5e5),
        moe=MoECfg(num_experts=16, top_k=1, d_expert=8192,
                   num_shared_experts=1, capacity_factor=1.25),
        mlp_activation="swiglu",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16),
        moe=MoECfg(num_experts=4, top_k=1, d_expert=64,
                   num_shared_experts=1, capacity_factor=2.0),
        dtype="float32", vocab_pad_multiple=8, name="llama4-smoke")
