"""ttamm — a two-tower retrieval framework with an adaptive mimic
mechanism, compiled with JAX/XLA for the GPU.

This is a from-scratch JAX/XLA framework providing the full
capability surface of the reference PyTorch project
``two-tower-augmented-with-adaptive-mimic-mechanism`` (see SURVEY.md), rebuilt
for an accelerator:

- host-side data layer (pandas) with identical preprocessing semantics,
- functional pytree models compiled with ``jax.jit`` / ``pjit``,
- on-device vectorised negative sampling (masked re-draw),
- sparse-row Adam for ID embedding tables (SparseAdam semantics),
- on-device chunked brute-force MIPS top-K (replaces FAISS),
- mesh-sharded embedding tables for multi-chip scale-out,
- the reference's full report/diagnostics artifact pipeline.
"""

__version__ = "0.1.0"
