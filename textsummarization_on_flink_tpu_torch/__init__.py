"""PyTorch/CUDA port of textsummarization_on_flink_tpu.

The JAX package beside this one is the reference: every module here
keeps its counterpart's name and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports torch and
numpy, never jax and nothing of the JAX package.

Ported so far: beam decode, training and eval of the pointer-generator
and of the transformer family (``cli.py --mode=train|eval|decode``) with
the trainer's byte-diet and long-run options, checkpoints both packages
read, the pipeline layer (``pipeline/``), the offline ETL
(``data/etl.py``), the obs plane (``obs/``), the resilience policy
(``resilience/``), the micro-batch serve layer (``serve/``) and the
(dp, tp, sp) mesh on ``torch.distributed`` for training, eval and batch
decode (``parallel/``), over
five hand-written
CUDA kernels for Hopper (``kernels/``): the fused additive attention and
its backward (``ops/fused_attention.py``), and the flash self-attention
forward, dK/dV and dQ (``ops/flash_attention.py``).  ROADMAP.md lists
what remains.
"""
