"""PyTorch/CUDA port of textsummarization_on_flink_tpu.

The JAX package beside this one is the reference: every module here
keeps its counterpart's name and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports torch and
numpy, never jax and nothing of the JAX package.

Ported so far: the batch beam-decode serving path (``cli.py
--mode=decode``) of the pointer-generator and of the transformer family,
with two hand-written CUDA kernels for Hopper: the fused additive
attention (``ops/fused_attention.py``, ``kernels/fused_attention.cu``)
and the transformer encoder's flash self-attention
(``ops/flash_attention.py``, ``kernels/flash_attention.cu``).
ROADMAP.md lists what remains.
"""
