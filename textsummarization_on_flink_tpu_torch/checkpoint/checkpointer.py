"""The npz checkpoint format, read and written by the port.

The same files as the JAX package's checkpoint/checkpointer.py: one
``.npz`` per checkpoint holding every leaf under its slash-joined key
path (``params/decoder/attention/W_h``, ``opt_state/accumulators/...``,
``step``), a sha256 manifest sidecar (``<ckpt>.sum``) and a
``checkpoint`` index file naming the newest one.  A checkpoint written
by either package loads in the other, and ``content_fingerprint`` hashes
the same bytes in the same order, so both packages give one params tree
one fingerprint.

Training state: ``state_to_arrays`` / ``arrays_to_state`` (the key scheme
``params/...``, ``opt_state/accumulators/...``, ``step`` as int32, so
each package restores the other's training checkpoints), the
``Checkpointer`` (max_to_keep=3 retention, the ``hparams.json`` sidecar,
restore with the corrupt-file fallback and the ``ckpt.load`` fault
point, which the trainer's divergence rollback also restores through)
and the eval side's ``BestModelSaver``.  bf16 accumulators
(``--opt_state_dtype=bfloat16``) are widened to f32 on save, as the JAX
package writes them (npz has no bf16; the widening is exact); the
Trainer narrows them again on resume.  Checkpoint surgery (``convert_to_coverage_model``,
``restore_best_model``) writes the JAX package's file names and index
files (checkpointer.py:542-605 there).
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch import params as params_lib
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.resilience import faultinject
from textsummarization_on_flink_tpu_torch.resilience.errors import (
    CheckpointCorruptError,
)
from textsummarization_on_flink_tpu_torch.train import trainer as trainer_lib

log = logging.getLogger(__name__)

CKPT_PREFIX = "model.ckpt"
INDEX_FILE = "checkpoint"  # latest-pointer file, tf.train.Saver protocol
BEST_INDEX_FILE = "checkpoint_best"
MANIFEST_SUFFIX = ".sum"  # checksum manifest sidecar


def _to_numpy(node: Any) -> np.ndarray:
    if isinstance(node, torch.Tensor):
        node = node.detach()
        if node.dtype == torch.bfloat16:
            # npz has no bf16; widen losslessly, as the JAX package does
            node = node.float()
        return node.cpu().numpy()
    return np.asarray(node)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten nested dicts/NamedTuples/lists to slash-joined keys, leaves
    as host numpy arrays (the JAX package's key scheme)."""
    out: Dict[str, np.ndarray] = {}

    def rec(node: Any, path: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}/{k}" if path else str(k))
        elif hasattr(node, "_fields"):  # NamedTuple
            for k in node._fields:
                rec(getattr(node, k), f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}/{i}" if path else str(i))
        else:
            out[path] = _to_numpy(node)

    rec(tree, prefix)
    return out


def _listify(node: Any) -> Any:
    """Turn {'0': .., '1': ..} dicts (flattened lists) back into lists."""
    if isinstance(node, dict):
        node = {k: _listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node) \
                and sorted(int(k) for k in node) == list(range(len(node))):
            return [node[str(i)] for i in range(len(node))]
    return node


def _unflatten_dicts(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Rebuild a nested tree from slash-joined keys (lists restored from
    their integer-key segments)."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


def content_fingerprint(tree: Any) -> str:
    """sha256 over every leaf's bytes in sorted flattened-name order,
    truncated to 16 hex chars — byte for byte the JAX package's scheme
    (checkpointer.py:147), so equal params give equal fingerprints in
    both packages."""
    flat = _flatten(tree)
    h = hashlib.sha256()
    for name in sorted(flat):
        h.update(name.encode("utf-8"))
        h.update(np.ascontiguousarray(flat[name]).tobytes())
    return h.hexdigest()[:16]


def _file_sha256(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
            size += len(block)
    return h.hexdigest(), size


def save_arrays(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write one npz atomically, then its checksum manifest (hashed from
    the temporary file before publish, so a manifest never describes a
    file it did not see)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    digest, size = _file_sha256(tmp)
    try:
        os.remove(path + MANIFEST_SUFFIX)  # never an old manifest on new bytes
    except OSError:
        pass
    os.replace(tmp, path)
    mtmp = path + MANIFEST_SUFFIX + ".tmp"
    with open(mtmp, "w", encoding="utf-8") as f:
        json.dump({"algo": "sha256", "hexdigest": digest, "bytes": size,
                   "file": os.path.basename(path)}, f)
    os.replace(mtmp, path + MANIFEST_SUFFIX)


def write_index(directory: str, ckpt_path: str,
                index_file: str = INDEX_FILE) -> None:
    """Point the directory's index file at ``ckpt_path``."""
    tmp = os.path.join(directory, index_file + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"model_checkpoint_path": os.path.basename(ckpt_path)}, f)
    os.replace(tmp, os.path.join(directory, index_file))


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def verify_manifest(path: str) -> bool:
    """True when ``path`` has a manifest and matches it, False when it has
    none; raises CheckpointCorruptError on a mismatch or an unreadable
    manifest."""
    mpath = path + MANIFEST_SUFFIX
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath, "r", encoding="utf-8") as f:
            manifest = json.load(f)
        want = manifest["hexdigest"]
        want_bytes = int(manifest.get("bytes", -1))
    except (OSError, ValueError, KeyError) as e:
        raise CheckpointCorruptError(
            f"unreadable checksum manifest {mpath}") from e
    got, size = _file_sha256(path)
    if got != want or (want_bytes >= 0 and size != want_bytes):
        raise CheckpointCorruptError(
            f"checkpoint {path} failed checksum verification "
            f"(manifest {want[:12]}.../{want_bytes}B, "
            f"file {got[:12]}.../{size}B)")
    return True


def load_arrays_verified(path: str, faults: Optional[Any] = None,
                         ) -> Dict[str, np.ndarray]:
    """Checksum-verify ``path`` (when it has a manifest), then load it
    (JAX checkpointer.py:236-251).  The ``ckpt.load`` fault point fires
    here, and a payload that will not decode is a CheckpointCorruptError,
    so every corruption takes the same fallback."""
    plan = faults if faults is not None else faultinject.plan()
    if plan.fire("ckpt.load"):
        raise CheckpointCorruptError(f"injected ckpt.load fault for {path}")
    verify_manifest(path)
    try:
        return load_arrays(path)
    except (ValueError, OSError, KeyError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} failed to decode: {e}") from e


def _ckpt_step(path: str) -> Tuple[int, int]:
    """Sort key (step, is_surgery): surgery outputs (`-<N>_cov_init.npz`)
    sort after the plain checkpoint of the same step."""
    m = re.search(r"-(\d+)(_[a-z_]+)?\.npz$", path)
    if not m:
        return (-1, 0)
    return (int(m.group(1)), 1 if m.group(2) else 0)


def latest_checkpoint(directory: str, index_file: str = INDEX_FILE,
                      ) -> Optional[str]:
    """The newest checkpoint path via the index file, falling back to a
    directory scan (tf.train.latest_checkpoint semantics)."""
    idx = os.path.join(directory, index_file)
    if os.path.exists(idx):
        try:
            with open(idx, "r", encoding="utf-8") as f:
                name = json.load(f)["model_checkpoint_path"]
            path = name if os.path.isabs(name) else os.path.join(directory, name)
            if os.path.exists(path):
                return path
        except (json.JSONDecodeError, KeyError, OSError):
            log.warning("unreadable checkpoint index %s; rescanning", idx)
    prefix = "bestmodel" if index_file == BEST_INDEX_FILE else CKPT_PREFIX
    found = sorted(glob.glob(os.path.join(directory, f"{prefix}-*.npz")),
                   key=_ckpt_step)
    return found[-1] if found else None


def _candidates(directory: str, index_file: str) -> List[str]:
    """Checkpoint paths newest first: the index-resolved latest, then the
    other files in descending step order (the corruption fallback)."""
    prefix = "bestmodel" if index_file == BEST_INDEX_FILE else CKPT_PREFIX
    found = sorted(glob.glob(os.path.join(directory, f"{prefix}-*.npz")),
                   key=_ckpt_step, reverse=True)
    latest = latest_checkpoint(directory, index_file)
    if latest is not None:
        if latest in found:
            found.remove(latest)
        found.insert(0, latest)
    return found


def load_ckpt(directory: str, index_file: str = INDEX_FILE,
              max_retries: Optional[int] = None, retry_secs: float = 10.0,
              faults: Optional[Any] = None,
              ) -> Tuple[str, Dict[str, np.ndarray]]:
    """(path, flat arrays) of the newest loadable checkpoint, checksum-
    verified, falling back over corrupt candidates
    (``resilience/ckpt_fallbacks_total``), retrying every ``retry_secs``
    until one appears (the reference's util.py:29-41 waits forever;
    ``max_retries`` bounds it).  ``faults``: the plan whose ``ckpt.load``
    point fires per candidate (the process default when None)."""
    attempt = 0
    while True:
        for path in _candidates(directory, index_file):
            try:
                return path, load_arrays_verified(path, faults)
            except CheckpointCorruptError as e:
                obs.counter("resilience/ckpt_fallbacks_total").inc()
                log.warning("checkpoint %s unusable (%s); falling back to "
                            "the next-older checkpoint", path, e)
            except OSError as e:  # raced with retention cleanup
                log.info("Failed to load checkpoint from %s: %s", path, e)
        attempt += 1
        if max_retries is not None and attempt > max_retries:
            raise FileNotFoundError(
                f"no loadable checkpoint in {directory} after "
                f"{max_retries} retries")
        log.info("Failed to load checkpoint from %s. Sleeping %.0f secs...",
                 directory, retry_secs)
        time.sleep(retry_secs)


# --------------------------------------------------------------------------
# Training state
# --------------------------------------------------------------------------

def state_to_arrays(state: "trainer_lib.TrainState",
                    plan: Any = None) -> Dict[str, np.ndarray]:
    """The flat npz dict of a TrainState (checkpointer.py:120-128).  With
    the ``plan`` of a mesh the state holds this rank's tp shards: they
    are all-gathered first (every rank of the mesh calls this)."""
    if plan is not None:
        state = plan.registry.gather_state(state)
    return _flatten({"params": state.params,
                     "opt_state": {"accumulators":
                                   state.opt_state.accumulators},
                     "step": np.asarray(state.step, np.int32)})


def arrays_to_state(flat: Dict[str, np.ndarray],
                    device: Any = "cpu") -> "trainer_lib.TrainState":
    """A TrainState on ``device`` from a flat npz dict
    (checkpointer.py:131-140): a params-only checkpoint gets zero
    accumulators and step 0, as in the JAX package."""
    tree = _unflatten_dicts(flat)
    acc = tree.get("opt_state", {}).get("accumulators")
    return trainer_lib.make_train_state(
        tree["params"], acc, int(np.asarray(tree.get("step", 0))), device)


def _remove_with_manifest(path: str) -> None:
    for f in (path, path + MANIFEST_SUFFIX):
        try:
            os.remove(f)
        except OSError:  # already gone
            pass


class Checkpointer:
    """Rolling-retention training checkpoints (Saver(max_to_keep=3)
    parity, checkpointer.py:360-481)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 hps: Optional[HParams] = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.hps = hps
        # a per-job fault plan (hps.faults) is resolved once, so its RNG
        # streams and fire budgets persist across restore() calls; the
        # process default (TS_FAULTS) stays resolved per use
        self._job_faults = (faultinject.plan_for(hps)
                            if hps is not None and hps.faults else None)
        os.makedirs(directory, exist_ok=True)
        self._sidecar_pending = hps is not None

    def _faults(self) -> Any:
        return (self._job_faults if self._job_faults is not None
                else faultinject.plan())

    def _write_sidecar(self) -> None:
        tmp = os.path.join(self.directory, f"hparams.json.tmp{os.getpid()}")
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(self.hps.to_json())
        os.replace(tmp, os.path.join(self.directory, "hparams.json"))
        self._sidecar_pending = False

    def save(self, state: "trainer_lib.TrainState", plan: Any = None) -> str:
        """Write ``state``.  On a mesh (``plan``) every rank calls this:
        the tp shards are gathered collectively, then only the chief
        writes the arrays, the sidecar, the index and the retention
        (JAX checkpointer.py:394-420), and every rank leaves after the
        write."""
        from textsummarization_on_flink_tpu_torch.parallel import (
            distributed,
        )

        flat = state_to_arrays(state, plan)
        path = os.path.join(self.directory,
                            f"{CKPT_PREFIX}-{int(flat['step'])}.npz")
        if distributed.is_chief():
            if self._sidecar_pending:
                self._write_sidecar()
            save_arrays(path, flat)
            write_index(self.directory, path)
            self._retain()
            log.info("saved checkpoint %s", path)
        distributed.barrier("checkpoint-save")
        return path

    def _retain(self) -> None:
        ckpts = sorted(
            glob.glob(os.path.join(self.directory, f"{CKPT_PREFIX}-*.npz")),
            key=_ckpt_step)
        for old in ckpts[: max(0, len(ckpts) - self.max_to_keep)]:
            _remove_with_manifest(old)
            log.info("removed old checkpoint %s", old)

    def restore(self, path: Optional[str] = None, device: Any = "cpu",
                ) -> Optional["trainer_lib.TrainState"]:
        """The state of ``path``, or of the newest loadable checkpoint
        (falling back over corrupt candidates); None when there is none.
        An explicit ``path`` that fails verification raises.  Accumulators
        come back as stored on disk (f32)."""
        if path is not None:
            return arrays_to_state(load_arrays_verified(path, self._faults()),
                                   device)
        try:
            _, flat = load_ckpt(self.directory, max_retries=0,
                                faults=self._faults())
        except FileNotFoundError:  # no loadable checkpoint
            return None
        return arrays_to_state(flat, device)

    def restore_sharded(self, plan: Any, path: Optional[str] = None,
                        device: Any = "cpu",
                        ) -> Optional["trainer_lib.TrainState"]:
        """``restore`` placed onto ``plan``'s mesh: this rank's shards
        (JAX checkpointer.py:483-507).  A checkpoint holds full arrays,
        so one saved on any mesh restores on any other, bit for bit after
        a gather.  bf16 accumulators (``--opt_state_dtype``) are narrowed
        before placement, as the Trainer does on resume."""
        state = self.restore(path, device=device)
        if state is None:
            return None
        state = trainer_lib.cast_opt_state(plan.hps, state)
        return plan.registry.shard_state(state)


class BestModelSaver:
    """Eval-side best-model track (run_summarization.py:250-292): keeps ONE
    ``bestmodel-<step>.npz`` under eval_dir, indexed by
    ``checkpoint_best``."""

    def __init__(self, eval_dir: str):
        self.eval_dir = eval_dir
        os.makedirs(eval_dir, exist_ok=True)

    def __call__(self, params: Any, running_avg_loss: float,
                 step: int) -> str:
        path = os.path.join(self.eval_dir, f"bestmodel-{step}.npz")
        old = glob.glob(os.path.join(self.eval_dir, "bestmodel-*.npz"))
        save_arrays(path, _flatten(params, "params"))
        write_index(self.eval_dir, path, BEST_INDEX_FILE)
        for o in old:
            if o != path:
                _remove_with_manifest(o)
        log.info("saved best model (loss %.4f) to %s", running_avg_loss, path)
        return path


# --------------------------------------------------------------------------
# Checkpoint surgery
# --------------------------------------------------------------------------

def convert_to_coverage_model(train_dir: str, hps: HParams, seed: int = 0,
                              force: bool = False) -> str:
    """Add a fresh coverage ``w_c`` to the newest non-coverage checkpoint
    and save it as ``<ckpt>_cov_init.npz`` (run_summarization.py:157-178:
    restore the non-coverage variables, initialise the new one, save and
    exit).  Every other leaf and accumulator is kept; ``w_c``'s
    accumulator starts at ``adagrad_init_acc``.

    Refuses a checkpoint that is itself a conversion (a second call would
    overwrite trained coverage params with fresh noise) unless ``force``,
    and the transformer, whose coverage penalty has no parameters."""
    path = latest_checkpoint(train_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {train_dir}")
    if "_cov_init" in os.path.basename(path) and not force:
        raise RuntimeError(
            f"latest checkpoint {path} is already a coverage conversion; "
            "re-converting would destroy trained coverage params "
            "(pass force=True to override)")
    tree = _unflatten_dicts(load_arrays(path))
    params = tree["params"]
    if "attention" not in (params.get("decoder") or {}):
        raise ValueError(
            "coverage conversion applies to the pointer_generator family "
            "only — the transformer's coverage penalty has no parameters "
            "to add, set --coverage directly")
    new_params = params_lib.add_coverage_params(params, seed)
    acc = tree.get("opt_state", {}).get("accumulators")
    if acc is None:  # a params-only checkpoint: zeros, as arrays_to_state
        acc = params_lib.tree_map(np.zeros_like, params)
    acc["decoder"]["attention"]["w_c"] = np.full_like(
        new_params["decoder"]["attention"]["w_c"], hps.adagrad_init_acc)
    out = path[: -len(".npz")] + "_cov_init.npz"
    save_arrays(out, _flatten({
        "params": new_params, "opt_state": {"accumulators": acc},
        "step": np.asarray(tree.get("step", 0), np.int32)}))
    write_index(train_dir, out)
    log.info("saved coverage-converted checkpoint %s", out)
    return out


def restore_best_model(eval_dir: str, train_dir: str, hps: HParams) -> str:
    """Copy the eval best model into the train dir with fresh Adagrad
    accumulators (run_summarization.py:132-154 restores only the
    non-Adagrad variables), saved as ``model.ckpt-<step>_restored.npz``
    with the step from the best model's file name."""
    path = latest_checkpoint(eval_dir, BEST_INDEX_FILE)
    if path is None:
        raise FileNotFoundError(f"no best model in {eval_dir}")
    params = _unflatten_dicts(load_arrays(path))["params"]
    acc = params_lib.tree_map(
        lambda p: np.full_like(p, hps.adagrad_init_acc), params)
    m = re.search(r"-(\d+)\.npz$", path)
    step = int(m.group(1)) if m else 0
    out = os.path.join(train_dir, f"{CKPT_PREFIX}-{step}_restored.npz")
    save_arrays(out, _flatten({"params": params,
                               "opt_state": {"accumulators": acc},
                               "step": np.asarray(step, np.int32)}))
    write_index(train_dir, out)
    log.info("restored best model %s -> %s", path, out)
    return out
