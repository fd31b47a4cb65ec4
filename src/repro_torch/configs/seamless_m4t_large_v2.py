"""SeamlessM4T-large v2 [arXiv:2308.11596] — enc-dec multimodal (audio)
backbone: 24 enc + 24 dec, d_model 1024, 16H (kv=16), d_ff 8192, vocab
256206 (padded to a model-axis multiple).  The mel+conv audio frontend is
a stub: frame embeddings arrive pre-computed.  A copy of
``repro/configs/seamless_m4t_large_v2.py``."""
from repro_torch.configs.base import AttnCfg, EncDecCfg, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, d_model=1024, d_ff=8192, vocab_size=256206,
        attn=AttnCfg(n_heads=16, n_kv_heads=16, head_dim=64),
        encdec=EncDecCfg(enc_layers=24, dec_layers=24, src_len=1024),
        frontend="audio", frontend_len=1024,
        mlp_activation="swiglu",
        source="arXiv:2308.11596",
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attn=AttnCfg(n_heads=4, n_kv_heads=4, head_dim=16),
        encdec=EncDecCfg(enc_layers=2, dec_layers=2, src_len=16),
        frontend_len=16, dtype="float32", vocab_pad_multiple=8,
        name="seamless-smoke")
