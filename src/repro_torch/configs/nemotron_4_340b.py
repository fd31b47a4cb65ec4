"""Nemotron-4 340B [arXiv:2402.16819] — dense, 96L, d_model 18432,
96H (GQA kv=8, head_dim 192), squared-ReLU MLP (2-matrix), vocab 256000.
A copy of ``repro/configs/nemotron_4_340b.py``."""
from repro_torch.configs.base import AttnCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, d_ff=73728, vocab_size=256000,
        attn=AttnCfg(n_heads=96, n_kv_heads=8, head_dim=192,
                     rope_theta=1e4),
        mlp_activation="squared_relu",
        source="arXiv:2402.16819",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=96, d_ff=256, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=24, rope_theta=1e4),
        dtype="float32", vocab_pad_multiple=8, name="nemotron-smoke")
