"""Small host-side utilities (JAX package utils.py)."""

from __future__ import annotations

from textsummarization_on_flink_tpu_torch.config import HParams


def local_batch_hps(hps: HParams) -> HParams:
    """One rank's view of a global config for BATCHER construction: on a
    (dp, tp, sp) mesh each rank's input pipeline yields
    ``batch_size / dp`` rows (the step functions keep the GLOBAL
    ``hps.batch_size``).

    The split is per dp index, not per process.  The JAX package divides
    by ``process_count`` (its utils.py:25-38) because each of its hosts
    owns whole dp rows of the device grid; a torch rank is one device,
    and the tp and sp ranks of one dp index compute on the SAME rows (tp
    splits the vocabulary, sp the encoder's time axis).  So every rank of
    one dp index must hold the same rows: the sharded trainer and
    evaluator broadcast each batch from the first rank of its dp index
    (parallel/collectives.broadcast_arrays), whatever the other ranks'
    batchers read."""
    if hps.dp <= 1:
        return hps
    if hps.batch_size % hps.dp != 0:
        raise ValueError(f"batch_size={hps.batch_size} must be divisible "
                         f"by dp={hps.dp}")
    return hps.replace(batch_size=hps.batch_size // hps.dp)
