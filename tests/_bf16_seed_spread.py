"""The spread of the bf16 rule of tests/test_torch_wide_clusters.py over
parameter seeds: for each hidden size (one head, 1 + 1 layers, T_enc 40,
the test's config) and seed, the JAX package's and the port's f32 and
bf16 losses and gradients on the test's batch, printed one JSON line per
case: JAX's own bf16-to-f32 loss distance, the port's, the port's bf16
loss from JAX's, their ratio (the test bounds the ratio of their means
over seeds 0-5 by BF16_GAP_FACTOR, 4) and the same ratio for the
gradient as a whole in the L2 norm (the test bounds it at seed 3).  With
``--outputs``, instead, each forward output of forward_train (JAX's
run eagerly, op by op; the test's runs under jax.jit) and the L2
distances between the four runs of it.

    JAX_PLATFORMS=cpu python tests/_bf16_seed_spread.py 2304,1152 0,1,2,3
    JAX_PLATFORMS=cpu python tests/_bf16_seed_spread.py 2304 3 --outputs

The test's loss rule takes seeds 0-5 (``BF16_SEEDS``), its gradient
rule seed 3 (``GRAD_SEED``); about 10 s a case on a CPU."""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]  # the tests and the repo

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_byte_diet import (  # noqa: E402
    _to_device,
    batch_arrays,
    jtfm,
    ttfm,
)
from test_torch_wide_clusters import VSIZE, _hps  # noqa: E402
from test_torch_wide_heads import (  # noqa: E402
    _jax_loss_and_grads,
    _port_loss_and_grads,
)

from textsummarization_on_flink_tpu_torch.params import (  # noqa: E402
    from_numpy_tree,
    init_numpy_params,
)


def _flat(leaves):
    return np.concatenate([np.ravel(x).astype(np.float64) for x in leaves])


def spread(hidden, seed):
    """One case: {name: value} as described above."""
    res = {}
    for dtype in ("float32", "bfloat16"):
        jhps, thps = _hps(hidden, mode="train", coverage=True,
                          max_oov_buckets=8, compute_dtype=dtype)
        p = init_numpy_params(thps, VSIZE, seed)
        arrays = batch_arrays(thps, 0)
        res[dtype] = (_jax_loss_and_grads("transformer", jhps, p, arrays),
                      _port_loss_and_grads("transformer", thps, p, arrays))
    (j32, jg32), (t32, _) = res["float32"]
    (j16, jg16), (t16, tg16) = res["bfloat16"]
    jax_gap = abs(j16 - j32)
    grad_gap = np.linalg.norm(_flat(jg16) - _flat(jg32))
    return dict(hidden=hidden, seed=seed, jax_f32=j32, port_f32=t32,
                jax_bf16=j16, port_bf16=t16, jax_gap=jax_gap,
                port_gap=abs(t16 - t32), port_from_jax=abs(t16 - j16),
                loss_ratio=abs(t16 - j16) / jax_gap,
                grad_ratio=float(np.linalg.norm(_flat(tg16) - _flat(jg16))
                                 / grad_gap))


def outputs(hidden, seed):
    """One case, output by output: {field: {name: L2 distance}}."""
    runs = {}
    for dtype in ("float32", "bfloat16"):
        jhps, thps = _hps(hidden, mode="train", coverage=True,
                          max_oov_buckets=8, compute_dtype=dtype)
        p = init_numpy_params(thps, VSIZE, seed)
        arrays = batch_arrays(thps, 0)
        ja = {k: jnp.asarray(v) for k, v in arrays.items()}
        runs["jax_" + dtype] = jtfm.forward_train(
            jax.tree_util.tree_map(jnp.asarray, p), jhps, ja)
        with torch.no_grad():
            runs["port_" + dtype] = ttfm.forward_train(
                from_numpy_tree(p), thps, _to_device(arrays, "cpu"))
    out = {}
    for field in runs["port_float32"]._fields:
        x = {k: getattr(r, field, None) for k, r in runs.items()}
        if any(v is None for v in x.values()):
            continue
        x = {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                           np.float64) for k, v in x.items()}

        def dist(a, b):
            return float(np.linalg.norm(np.ravel(x[a] - x[b])))

        out[field] = dict(
            jax_gap=dist("jax_bfloat16", "jax_float32"),
            port_gap=dist("port_bfloat16", "port_float32"),
            port_from_jax=dist("port_bfloat16", "jax_bfloat16"),
            f32_port_from_jax=dist("port_float32", "jax_float32"))
    return out


def main(argv):
    hiddens = [int(h) for h in argv[1].split(",")]
    seeds = [int(s) for s in argv[2].split(",")]
    for hidden in hiddens:
        for seed in seeds:
            row = (dict(hidden=hidden, seed=seed, outputs=outputs(hidden,
                                                                  seed))
                   if "--outputs" in argv else spread(hidden, seed))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv)
