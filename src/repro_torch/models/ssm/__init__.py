"""Tree-aware recurrent layers: Mamba2, Gated Delta Net and RWKV6."""
