"""Model configuration schema.

A copy of ``repro/configs/base.py``'s dataclasses (the port imports nothing
of the reference package); ``tests/test_torch_serve.py`` holds the copy
against the original field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    window: Optional[int] = None       # sliding-window size (positions); None = full
    softmax_scale: Optional[float] = None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int                       # per-expert FFN hidden dim
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0         # leading dense layers (DeepSeek/Kimi style)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-4


@dataclass(frozen=True)
class SSMCfg:
    kind: str                           # 'mamba2' | 'rwkv6' | 'gdn'
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4                # causal conv width (mamba2/gdn)
    chunk_size: int = 64                # tree chunk grid


@dataclass(frozen=True)
class HybridCfg:
    """Zamba2-style: shared full-attention block every k SSM layers."""
    attn_every: int = 6
    concat_embed: bool = True           # shared block consumes [h ; embed0]


@dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int
    dec_layers: int
    src_len: int = 1024                 # frontend frames for dry-run specs


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnCfg] = None
    mlp_activation: str = "swiglu"      # swiglu | squared_relu | relu_sq_glu
    mlp_bias: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid: Optional[HybridCfg] = None
    encdec: Optional[EncDecCfg] = None
    frontend: Optional[str] = None      # None | 'audio' | 'vision'
    frontend_len: int = 0               # stub prefix length (patches/frames)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    remat: str = "none"                 # none | full (checkpoint scan body)
    source: str = ""                    # citation

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count of a dense or MoE decoder (the
        reference's formula)."""
        D, F, L = self.d_model, self.d_ff, self.n_layers
        emb = self.padded_vocab * D * (1 if self.tie_embeddings else 2)
        a = self.attn
        per_attn = D * a.q_dim + 2 * D * a.kv_dim + a.q_dim * D
        mult = 3 if self.mlp_activation == "swiglu" else 2
        if self.moe is None:
            return emb + L * (per_attn + mult * D * F)
        m = self.moe
        routed = m.num_experts * mult * D * m.d_expert
        shared = m.num_shared_experts * mult * D * m.d_expert
        fd = m.first_dense_layers
        return emb + fd * (per_attn + mult * D * F) + (L - fd) * (
            per_attn + routed + shared + D * m.num_experts)


_NESTED = {"attn": AttnCfg, "moe": MoECfg, "ssm": SSMCfg,
           "hybrid": HybridCfg, "encdec": EncDecCfg}


def config_from_dict(d: dict) -> ModelConfig:
    """Rebuild a ModelConfig from ``dataclasses.asdict`` of one (this
    package's or the reference's: the fields are the same)."""
    d = dict(d)
    for key, cls in _NESTED.items():
        if d.get(key) is not None:
            d[key] = cls(**d[key])
    return ModelConfig(**d)
