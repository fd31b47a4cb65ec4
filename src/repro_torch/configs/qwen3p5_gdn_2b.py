"""Qwen3.5-style GDN stack (the paper's App. A hybrid SSM component) — a
2B Gated-Delta-Net decoder exercising tree state routing and the
tree-correct causal conv (App. A.2/A.3).
A copy of ``repro/configs/qwen3p5_gdn_2b.py``."""
from repro_torch.configs.base import ModelConfig, SSMCfg


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3p5-gdn-2b", family="ssm",
        n_layers=24, d_model=2048, d_ff=8192, vocab_size=151936,
        ssm=SSMCfg(kind="gdn", head_dim=128, expand=1, conv_kernel=4,
                   chunk_size=64),
        mlp_activation="swiglu",
        source="paper App. A (GDN; Qwen3.5 component)",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, d_ff=128, vocab_size=512,
        ssm=SSMCfg(kind="gdn", head_dim=16, expand=1, conv_kernel=4,
                   chunk_size=8),
        dtype="float32", vocab_pad_multiple=8, name="gdn-smoke")
