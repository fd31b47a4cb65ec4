"""PyTorch/CUDA port of the tree-training system (``src/repro`` is the JAX
reference it is held against).

The first slice is serving: ``serve.rollout.rollout_group`` and
``serve.session.DecodeSession`` over a dense decoder, with the prefill's
tree attention in a hand-written Hopper kernel
(``kernels/csrc/tree_attention_fwd.cu``).  The package imports torch and
numpy only, never jax and never the reference package.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.
"""
