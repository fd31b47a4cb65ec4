"""The port's framework-free checks, counterparts of ``repro/analysis``'s
passes that read no jaxpr:

  lock lint       every write to a lock-guarded field of the async layers
                  happens under its lock (``lock_lint``, an AST walk);
  mask soundness  the block-skip predicate ``kernels/tree_attention.
                  block_live`` never skips a tile that holds a visible
                  (query, key) pair, on a boundary sweep over the port
                  kernels' tile shapes and on packed rows (``mask_check``);
  signatures      each planned step's shape signatures and the enumerable
                  universe they stay in (``signatures``), which the
                  compile warm-up (``train/warmup``) makes ready.

The CUDA kernels carry their own copies of the predicate, which no Python
check can hold by identity; ``chip_smoke.py``'s ``mask soundness`` phase
holds them on the card instead (NaN in every tile the predicate skips
must leave every output unchanged).  The reference's jaxpr and HLO
passes and its signature lint wait for ROADMAP.md Queue A item 7f.
"""
