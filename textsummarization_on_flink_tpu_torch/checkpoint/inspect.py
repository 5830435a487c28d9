"""Checkpoint NaN/Inf inspector.

Port of the JAX package's checkpoint/inspect.py (after the reference's
inspect_checkpoint.py:11-45): scan every tensor of an npz checkpoint and
report which are finite, which hold some non-finite values and which
are entirely non-finite.

Usage: python -m textsummarization_on_flink_tpu_torch.checkpoint.inspect <file.npz>
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from textsummarization_on_flink_tpu_torch.checkpoint.checkpointer import (
    load_arrays,
)


def inspect_arrays(flat: Dict[str, np.ndarray]) -> Dict[str, List[str]]:
    """{"finite", "some_infnan", "all_infnan"}: the names of each kind, in
    sorted order (non-float tensors count as finite)."""
    finite, some_bad, all_bad = [], [], []
    for name in sorted(flat):
        v = np.asarray(flat[name])
        if not np.issubdtype(v.dtype, np.floating) and \
                not np.issubdtype(v.dtype, np.complexfloating):
            finite.append(name)
            continue
        bad = ~np.isfinite(v)
        if not bad.any():
            finite.append(name)
        elif bad.all():
            all_bad.append(name)
        else:
            some_bad.append(name)
    return {"finite": finite, "some_infnan": some_bad, "all_infnan": all_bad}


def main(argv: List[str]) -> int:
    """Print the report of one checkpoint; 0 when it is all finite, 1 when
    not, 2 on a usage error."""
    if len(argv) != 1:
        print("USAGE: python -m textsummarization_on_flink_tpu_torch."
              "checkpoint.inspect <checkpoint.npz>", file=sys.stderr)
        return 2
    flat = load_arrays(argv[0])
    report = inspect_arrays(flat)
    print(f"{len(flat)} tensors in {argv[0]}")
    for name in report["finite"]:
        print(f"  ok      {name}")
    for name in report["some_infnan"]:
        print(f"  SOMEBAD {name}  (contains some inf/nan)")
    for name in report["all_infnan"]:
        print(f"  ALLBAD  {name}  (entirely inf/nan)")
    if not report["some_infnan"] and not report["all_infnan"]:
        print("CHECK PASSED: checkpoint contains no inf/NaN values")
        return 0
    print("CHECK FAILED: checkpoint contains inf/NaN values")
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
