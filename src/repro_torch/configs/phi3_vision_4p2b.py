"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct] — the
phi3-mini LM backbone (32L, d_model 3072, 32H/32KV) consuming CLIP-ViT
patch embeddings through a projector; the frontend is a stub (patch
embeddings of the projector's output shape arrive pre-computed).  A copy
of ``repro/configs/phi3_vision_4p2b.py``."""
from repro_torch.configs.base import AttnCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, d_ff=8192, vocab_size=32064,
        attn=AttnCfg(n_heads=32, n_kv_heads=32, head_dim=96),
        frontend="vision", frontend_len=576,   # 24x24 CLIP-L patch grid
        mlp_activation="swiglu",
        source="hf:microsoft/Phi-3-vision-128k-instruct",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=4, head_dim=16),
        frontend_len=8, dtype="float32", vocab_pad_multiple=8,
        name="phi3v-smoke")
