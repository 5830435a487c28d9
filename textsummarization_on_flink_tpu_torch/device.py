"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  A
missing card is an error, never a silent move to the CPU: a decode that
quietly ran on the CPU would report CPU times under the card's name.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The torch device for ``name`` ("cuda" or "cpu").  Raises when
    "cuda" is asked for and no CUDA device is present."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    # f32 everywhere, as the JAX package's compute_dtype=float32: TF32
    # keeps ~3 decimal digits and would break parity with the reference,
    # so both switches are turned off explicitly (the cuDNN one defaults
    # to on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # under compute_dtype=bfloat16 the bf16 GEMMs sum in f32 and round
    # once, as the JAX package's preferred_element_type=f32 products do:
    # no reduced-precision partial sums (on by default)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device=cpu on the command line) to run on the CPU")
    return torch.device(name)
