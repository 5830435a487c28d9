"""One rank of the port's mesh tests (NOT a pytest file).

tests/_torch_mesh.py spawns N of these with torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT); each joins a gloo world on the CPU through
``parallel.distributed.initialize()`` and runs the cases of
``<workdir>/job.json`` in order, reading its inputs from npz files in
``workdir`` and writing its results there.  Imports only the port.

Usage (spawned by the tests, not by hand):
    python _torch_mesh_worker.py <workdir>
"""

import json
import os
import sys

import numpy as np
import torch

from textsummarization_on_flink_tpu_torch.checkpoint import checkpointer
from textsummarization_on_flink_tpu_torch.config import HParams
from textsummarization_on_flink_tpu_torch.parallel import (
    collectives,
    distributed,
    mesh,
    ring_attention,
)
from textsummarization_on_flink_tpu_torch.params import from_numpy_tree
from textsummarization_on_flink_tpu_torch.train import trainer


def _load(workdir, name):
    with np.load(os.path.join(workdir, name + ".npz")) as z:
        return {k: z[k] for k in z.files}


def _tree(flat):
    return checkpointer._unflatten_dicts(flat)


def _save(workdir, name, arrays=None, info=None):
    if arrays is not None:
        np.savez(os.path.join(workdir, name + ".npz"), **arrays)
    if info is not None:
        with open(os.path.join(workdir, name + ".json"), "w") as f:
            json.dump(info, f)


def run_train(case, hps, workdir, rank):
    """``steps`` sharded train steps on the global batch; the chief
    writes the per-step metrics, the gathered state and the bytes each
    collective moved per step."""
    params = _tree(_load(workdir, case["params"]))["params"]
    batch = _load(workdir, case["batch"])
    plan = mesh.make_mesh(hps)
    mesh.validate_divisibility(hps, params)
    state = trainer.init_train_state(hps, 0, params=params,
                                     device=torch.device("cpu"))
    state = mesh.shard_train_state(plan, state)
    local_vocab = int(state.params["embedding"].shape[0])
    step = mesh.make_sharded_train_step(plan)
    arrays = {k: torch.as_tensor(v) for k, v in
              mesh.shard_batch(plan, batch).items()}
    arrays = {k: (v.float() if v.is_floating_point() else v.long())
              for k, v in arrays.items()}
    before = collectives.counted_bytes(hps)
    rows = []
    for _ in range(case.get("steps", 1)):
        state, m = step(state, arrays)
        rows.append([float(x) for x in m])
    after = collectives.counted_bytes(hps)
    flat = checkpointer.state_to_arrays(state, plan)
    n = case.get("steps", 1)
    per_step = {k: (after[k] - before.get(k, 0.0)) / n for k in after}
    acc_dtypes = sorted({str(a.dtype) for a in
                         trainer.tree_leaves(state.opt_state.accumulators)})
    if case.get("local"):
        # this rank's shards as they are (pad heads included)
        _save(workdir, f"{case['name']}.local.rank{rank}",
              checkpointer._flatten({
                  "params": state.params,
                  "accumulators": state.opt_state.accumulators}, ""))
    restored_equal = None
    if case.get("checkpoint"):
        # a checkpoint of the sharded state, restored onto the mesh
        ckpt = checkpointer.Checkpointer(
            os.path.join(workdir, case["name"] + "_ckpt"))
        ckpt.save(state, plan)
        back = ckpt.restore_sharded(plan)
        restored_equal = all(
            torch.equal(a.detach(), b.detach()) for a, b in zip(
                trainer.tree_leaves(state.params)
                + trainer.tree_leaves(state.opt_state.accumulators),
                trainer.tree_leaves(back.params)
                + trainer.tree_leaves(back.opt_state.accumulators)))
    if plan.is_chief:
        _save(workdir, case["name"], flat,
              {"metrics": rows, "bytes_per_step": per_step,
               "local_vocab": local_vocab, "acc_dtypes": acc_dtypes,
               "restored_equal": restored_equal})


def run_eval(case, hps, workdir, rank):
    params = _tree(_load(workdir, case["params"]))["params"]
    batch = _load(workdir, case["batch"])
    plan = mesh.make_mesh(hps)
    shards = plan.registry.shard_params(from_numpy_tree(params, "cpu"))
    eval_step = mesh.make_sharded_eval_step(plan)
    arrays = {k: torch.as_tensor(v) for k, v in
              mesh.shard_batch(plan, batch).items()}
    arrays = {k: (v.float() if v.is_floating_point() else v.long())
              for k, v in arrays.items()}
    m = eval_step(shards, arrays)
    if plan.is_chief:
        _save(workdir, case["name"], info={"metrics": [float(x) for x in m]})


def run_search(case, hps, workdir, rank):
    """The sharded beam search of the whole batch on every rank."""
    params = _tree(_load(workdir, case["params"]))["params"]
    batch = _load(workdir, case["batch"])
    plan = mesh.make_mesh(hps)
    shards = plan.registry.shard_params(from_numpy_tree(params, "cpu"))
    out = mesh.make_sharded_beam_search(plan)(shards, batch)
    _save(workdir, f"{case['name']}.rank{rank}",
          {"tokens": out.tokens, "length": out.length,
           "avg_log_prob": out.avg_log_prob})


def run_head_mean(case, hps, workdir, rank):
    """collectives.head_mean of this rank's heads of a [B, heads, T]
    array whose heads are padded to a multiple of tp (the pad heads are
    the array's trailing ones); the chief writes the mean."""
    x = torch.from_numpy(_load(workdir, case["inputs"])["probs"])
    plan = mesh.make_mesh(hps)
    held = x.shape[1] // plan.tp
    local = x[:, plan.coord("tp") * held:(plan.coord("tp") + 1) * held]
    with collectives.bound(plan):
        mean = collectives.head_mean(local, 1, hps.num_heads)
    if plan.is_chief:
        _save(workdir, case["name"], {"mean": mean.numpy()})


def run_attention(case, hps, workdir, rank):
    """Ring or Ulysses attention of this rank's sp block: forward, and the
    backward of the given cotangent; the blocks all-gathered over sp."""
    x = _load(workdir, case["inputs"])
    plan = mesh.make_mesh(hps)
    reg = plan.registry
    s, sp = plan.coord("sp"), plan.sp

    def block(a):
        a = torch.from_numpy(reg.dp_rows({"a": a})["a"])
        return a.chunk(sp, dim=1)[s].contiguous()

    q, k, v = (block(x[n]).requires_grad_(True) for n in ("q", "k", "v"))
    mask, g = block(x["mask"]), block(x["g"])
    with collectives.bound(plan):
        out = ring_attention.sp_attention(case["mode"], q, k, v, mask,
                                          float(x["scale"]))
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    res = {n: collectives.all_gather(plan, collectives.all_gather(
        plan, t.detach(), "sp", 1), "dp", 0).numpy()
        for n, t in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}
    if plan.is_chief:
        _save(workdir, case["name"], res)


def run_decoder(case, hps, workdir, rank):
    """BeamSearchDecoder on a mesh: the chief's results of one batch; the
    tier a sharded decoder refuses; the slot engine it builds (no
    collective at construction)."""
    from textsummarization_on_flink_tpu_torch.data.batching import (
        Batch,
        SummaryExample,
    )
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        BeamSearchDecoder,
    )

    params = _tree(_load(workdir, case["params"]))["params"]
    vocab = Vocab(words=case["words"])
    exs = [SummaryExample.build(a, [r], vocab, hps)
           for a, r in zip(case["articles"], case["abstracts"])]
    dec = BeamSearchDecoder(hps, vocab, batcher=None, params=params,
                            decode_root=os.path.join(workdir, "dec"))
    results = dec.decode_batch(Batch(exs, hps, vocab))
    refused = []
    try:
        dec.decode_batch(Batch(exs, hps, vocab), tier="greedy")
    except ValueError as e:
        refused.append(f"{type(e).__name__}: {e}")
    engine = dec.slot_engine(4, 2)
    _save(workdir, f"{case['name']}.rank{rank}", info={
        "sharded": dec.sharded, "refused": refused,
        "engine_local_slots": engine._local,
        "words": [r.decoded_words for r in results]})


class FixedBatcher:
    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def next_batch(self):
        if self.n <= 0:
            return None
        self.n -= 1
        return self.batch


def run_continuous(case, hps, workdir, rank):
    """Continuous decode (``single_pass=0``) from a train dir on a mesh,
    with the reload cadence straddling the ranks: on the ranks named by
    ``due_on`` a reload is due at every batch by their own clock, on the
    others never; a newer checkpoint lands after the first load.  Every
    rank reports the checkpoint it starts and ends on."""
    from textsummarization_on_flink_tpu_torch.data.batching import (
        Batch,
        SummaryExample,
    )
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.decode import decoder as dec_lib

    vocab = Vocab(words=case["words"])
    batch = Batch([SummaryExample.build(a, [r], vocab, hps)
                   for a, r in zip(case["articles"], case["abstracts"])],
                  hps, vocab)
    train_dir = os.path.join(workdir, case["name"])
    dec = dec_lib.BeamSearchDecoder(
        hps, vocab, FixedBatcher(batch, case["batches"]),
        train_dir=train_dir, decode_root=os.path.join(train_dir, "dec"),
        max_ckpt_retries=0)
    first = dec._params_snapshot()[1]
    distributed.barrier("first-load")
    if rank == 0:
        newer = os.path.join(train_dir, "model.ckpt-6.npz")
        checkpointer.save_arrays(newer, _load(workdir, case["newer"]))
        checkpointer.write_index(train_dir, newer)
    distributed.barrier("newer-written")
    due = rank == 0 if case["due_on"] == "chief" else rank != 0
    dec_lib.SECS_UNTIL_NEW_CKPT = 0.0 if due else 1e9
    reloads = dec._c_reloads._value
    results = []
    dec.decode(result_sink=results.append, max_batches=case["batches"],
               log_results=False)
    _save(workdir, f"{case['name']}.rank{rank}", info={
        "first": os.path.basename(first),
        "last": os.path.basename(dec._params_snapshot()[1]),
        "reloads": dec._c_reloads._value - reloads,
        "fingerprint": dec.params_fingerprint, "results": len(results)})


def run_trainer(case, hps, workdir, rank):
    """The Trainer and the Checkpointer on a mesh (the counterpart of the
    JAX package's tests/_multiproc_worker.py): 5 steps with a save every
    3, a restore on every rank, a resume to step 7."""
    from textsummarization_on_flink_tpu_torch.data.batching import (
        Batch,
        SummaryExample,
    )
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.utils import local_batch_hps

    vocab = Vocab(words=["a", "b", "c", "d", "e", "f", "g", "."])
    local_hps = local_batch_hps(hps)
    plan = mesh.make_mesh(hps)
    d = plan.coord("dp")
    # the rows of one dp index; the tp ranks of it read them too (and the
    # trainer broadcasts the first one's batch in any case)
    texts = [["a b c d", "b c d e", "c d e f", "d e f a"],
             ["f e d c", "e d c b", "d c b a", "c b a f"],
             ["a c e g", "b d f a", "g f e d", "e c a b"],
             ["d d c c", "b b a a", "f f g g", "a b a b"]][d]
    texts = texts[:local_hps.batch_size]
    exs = [SummaryExample.build(t, [t.split()[0] + " ."], vocab, local_hps)
           for t in texts]
    batch = Batch(exs, local_hps, vocab)
    train_dir = os.path.join(workdir, case["name"], "train")
    ckpt = checkpointer.Checkpointer(train_dir, hps=hps)
    tr = trainer.Trainer(hps, vocab.size(), FixedBatcher(batch, 50),
                         checkpointer=ckpt, train_dir=train_dir,
                         metrics_every=2)
    state = tr.train(num_steps=5)
    info = {"final_step": state.step, "is_chief": distributed.is_chief(),
            "local_vocab": int(state.params["embedding"].shape[0])}
    distributed.barrier("post-train")
    restored = ckpt.restore()
    info["restored_step"] = restored.step
    info["param_checksum"] = float(sum(
        np.abs(p.detach().numpy()).astype(np.float64).sum()
        for p in trainer.tree_leaves(restored.params)))
    info["ckpt_files"] = sorted(p for p in os.listdir(train_dir)
                                if p.endswith(".npz"))
    # the full checkpoint placed on this mesh and gathered back: the same
    # bits; bf16 accumulators narrowed before placement
    on_disk = checkpointer.load_arrays(os.path.join(train_dir,
                                                    "model.ckpt-5.npz"))
    sharded = ckpt.restore_sharded(plan)
    info["local_vocab_restored"] = int(sharded.params["embedding"].shape[0])
    back = checkpointer.state_to_arrays(sharded, plan)
    info["restore_sharded_bitwise"] = sorted(back) == sorted(on_disk) and all(
        np.array_equal(back[k], on_disk[k]) for k in on_disk)
    narrow = ckpt.restore_sharded(mesh.make_mesh(
        hps.replace(opt_state_dtype="bfloat16")))
    info["narrowed_acc_dtypes"] = sorted({str(a.dtype) for a in
                                          trainer.tree_leaves(
                                              narrow.opt_state.accumulators)})
    # the Evaluator on the mesh: the chief-written checkpoint's full
    # params, sharded per rank; only the chief writes
    eval_dir = os.path.join(workdir, case["name"], "eval")
    ev = trainer.Evaluator(hps.replace(mode="eval"), FixedBatcher(batch, 1),
                           eval_dir=eval_dir,
                           best_saver=checkpointer.BestModelSaver(eval_dir))
    info["eval_loss"] = ev.run(restored.params, restored.step)
    tr2 = trainer.Trainer(hps.replace(steps_per_dispatch=2), vocab.size(),
                          FixedBatcher(batch, 50), state=restored,
                          checkpointer=ckpt, train_dir=train_dir)
    info["resumed_step"] = tr2.train(num_steps=7).step
    distributed.barrier("post-resume")
    _save(workdir, f"{case['name']}.rank{rank}", info=info)


def _serve_inputs(case, hps):
    from textsummarization_on_flink_tpu_torch.data.batching import (
        SummaryExample,
    )
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab

    vocab = Vocab(words=case["words"])
    exs = [SummaryExample.build(a, [r], vocab, hps, uuid=f"u{i}")
           for i, (a, r) in enumerate(zip(case["articles"],
                                          case["abstracts"]))]
    return vocab, exs


def run_slot_engine(case, hps, workdir, rank):
    """The JAX package's test_serve_slot_engine_runs_sharded on the mesh:
    the chief packs the articles into slots 0, 1, .. and steps until every
    one finished, unpacking each; the other ranks follow
    (serve.mesh.follow).  Every rank writes its share of the state."""
    from textsummarization_on_flink_tpu_torch.decode.decoder import (
        BeamSearchDecoder,
    )
    from textsummarization_on_flink_tpu_torch.serve import mesh as serve_mesh

    params = _tree(_load(workdir, case["params"]))["params"]
    vocab, exs = _serve_inputs(case, hps)
    dec = BeamSearchDecoder(hps, vocab, batcher=None, params=params,
                            decode_root=os.path.join(workdir, case["name"]))
    eng = dec.slot_engine(slots=case["slots"], chunk=case["chunk"])
    before = collectives.counted_bytes(hps)
    info = {}
    if rank == 0:
        for i, ex in enumerate(exs):
            eng.pack(i, ex)
        results = {}
        for _ in range(hps.max_dec_steps + 2):
            for idx in eng.step():
                results[idx] = eng.unpack(idx, exs[idx])
            if len(results) == len(exs):
                break
        dec.release_followers()
        info["words"] = [results[i].decoded_words for i in range(len(exs))]
        info["free_pages"] = eng.free_pages() if eng.paged else None
    else:
        info["ops"] = serve_mesh.follow(dec, eng)
    after = collectives.counted_bytes(hps)
    info["bytes"] = {k: v - before.get(k, 0.0) for k, v in after.items()}
    info["cache_sizes"] = {k: list(v) for k, v in eng.cache_sizes().items()}
    info["resident_bytes_per_slot"] = eng.resident_bytes_per_slot()
    _save(workdir, f"{case['name']}.rank{rank}", info=info)


def _drain(futs, timeout=120.0):
    words, errors = {}, {}
    for uuid, f in futs.items():
        try:
            words[uuid] = f.result(timeout=timeout).decoded_words
        except Exception as e:  # noqa: BLE001 - reported to the test
            errors[uuid] = f"{type(e).__name__}: {e}"
    return words, errors


def run_serve(case, hps, workdir, rank):
    """A ServingServer on the mesh (every rank builds it; the chief serves
    and the others follow).  ``how``: "serve" (submit every article, wait
    for them, stop), "ticks" (the articles queued, then driven by
    tick_once to the end: deterministic), "kill" (kill after the first
    result, residents in flight), "fail" (the chief's second engine step
    raises), "swap" (a hot swap to a newer checkpoint between two
    requests)."""
    from textsummarization_on_flink_tpu_torch import obs
    from textsummarization_on_flink_tpu_torch.checkpoint import (
        checkpointer as ckpt_lib,
    )
    from textsummarization_on_flink_tpu_torch.decode import beam_search
    from textsummarization_on_flink_tpu_torch.serve.server import (
        ServingServer,
    )

    how = case["how"]
    vocab, _ = _serve_inputs(case, hps)
    reg = obs.Registry()
    kw = {}
    if how == "swap":
        train_dir = os.path.join(workdir, case["name"], "train")
        if rank == 0:
            ckpt_lib.save_arrays(os.path.join(train_dir, "model.ckpt-1.npz"),
                                 _load(workdir, case["params"]))
            ckpt_lib.write_index(train_dir, os.path.join(
                train_dir, "model.ckpt-1.npz"))
        distributed.barrier("swap-ckpt")
        kw["train_dir"] = train_dir
    else:
        kw["params"] = _tree(_load(workdir, case["params"]))["params"]
    server = ServingServer(hps, vocab, decode_root=os.path.join(
        workdir, case["name"]), registry=reg, **kw)
    info = {}
    if rank != 0:
        info["ops"] = server.follow()
    else:
        arts = list(zip(case["articles"], case["abstracts"]))
        if how == "fail":
            orig, calls = beam_search.step_slots, [0]

            def flaky(*a, **k):
                calls[0] += 1
                if calls[0] == 2:
                    raise RuntimeError("injected step failure")
                return orig(*a, **k)

            beam_search.step_slots = flaky
        if how == "ticks":
            futs = {f"u{i}": server.submit(a, uuid=f"u{i}", reference=r)
                    for i, (a, r) in enumerate(arts)}
            for _ in range(500):
                if all(f.done() for f in futs.values()):
                    break
                server.tick_once()
            server.stop()
        elif how == "swap":
            server.start()
            first = server.submit(arts[0][0], uuid="u0").result(timeout=120)
            newer = os.path.join(kw["train_dir"], "model.ckpt-2.npz")
            ckpt_lib.save_arrays(newer, _load(workdir, case["newer"]))
            ckpt_lib.write_index(kw["train_dir"], newer)
            info["swapped"] = server.hot_swap()
            second = server.submit(arts[1][0], uuid="u1").result(timeout=120)
            server.stop()
            info["fingerprints"] = [first.params_fingerprint,
                                    second.params_fingerprint]
            futs = {}
        else:
            server.start()
            futs = {f"u{i}": server.submit(a, uuid=f"u{i}", reference=r,
                                           block=True)
                    for i, (a, r) in enumerate(arts)}
            if how == "kill":
                next(iter(futs.values())).result(timeout=120)
                info["active_at_kill"] = server.stats().get("slots_active")
                info["rejected"] = server.kill()
            else:
                server.stop()
        info["words"], info["errors"] = _drain(futs)
        info["counters"] = {k: reg.counter(f"serve/{k}").value for k in (
            "arena_alloc_failures_total", "slot_refills_total",
            "completed_total", "errors_total", "prefill_total")}
    info["fingerprint"] = server._decoder.params_fingerprint
    _save(workdir, f"{case['name']}.rank{rank}", info=info)


def run_pipeline(case, hps, workdir, rank):
    """App.main on the mesh (every rank; the chief reads the sources and
    writes the sink), then the inference job again through the serve
    layer (transform(serving=True)).  The chief writes both sinks' rows."""
    from textsummarization_on_flink_tpu_torch.data.vocab import Vocab
    from textsummarization_on_flink_tpu_torch.pipeline import app as app_lib
    from textsummarization_on_flink_tpu_torch.pipeline import io

    rows = [tuple(r) for r in case["rows"]]
    infer = [tuple(r) for r in case["infer_rows"]]
    a = app_lib.App(train_hps=hps,
                    inference_hps=HParams(device="cpu", **case["decode"]),
                    vocab=Vocab(words=case["words"]))
    sink, served = io.CollectionSink(), io.CollectionSink()
    a.main(train_source=io.CollectionSource(rows),
           infer_source=io.CollectionSource(infer), sink=sink)
    a.start_inference(None, io.CollectionSource(infer), served, serving=True)
    _save(workdir, f"{case['name']}.rank{rank}", info={
        "rows": sorted(sink.rows), "served": sorted(served.rows)})


def run_saved(case, hps, workdir, rank):
    """One sharded train step on the global batch, recording what each
    attention autograd Function saved for its backward: the fused
    attention's es and ef (shapes, and their bytes, each tensor once),
    and the flash attention's q, k, v and out shapes with its causal
    flag."""
    from textsummarization_on_flink_tpu_torch.ops import flash_attention as fl
    from textsummarization_on_flink_tpu_torch.ops import fused_attention as fa

    seen, flash = [], []
    originals = {}
    for cls in (fa.FusedAttention, fa.FusedAttentionSP):
        originals[cls] = cls.forward

        def forward(ctx, *args, _orig=originals[cls], _name=cls.__name__):
            out = _orig(ctx, *args)
            seen.append((_name, ctx.to_save[0], ctx.to_save[1]))
            return out

        cls.forward = staticmethod(forward)
    originals[fl.FlashAttention] = fl.FlashAttention.forward

    def flash_forward(ctx, *args, _orig=originals[fl.FlashAttention]):
        out = _orig(ctx, *args)
        q, k, v, o = ctx.to_save[:4]
        flash.append(dict(causal=bool(ctx.causal), q=list(q.shape),
                          k=list(k.shape), v=list(v.shape),
                          out=list(o.shape)))
        return out

    fl.FlashAttention.forward = staticmethod(flash_forward)
    try:
        run_train(dict(case, name=f"{case['name']}.train"), hps, workdir,
                  rank)
    finally:
        for cls, fwd in originals.items():
            cls.forward = staticmethod(fwd)
    unique = {}
    for _, es, ef in seen:
        for x in (es, ef):
            unique[x.data_ptr()] = x.numel() * x.element_size()
    _save(workdir, f"{case['name']}.rank{rank}", info={
        "saved": sorted({(name, tuple(es.shape), tuple(ef.shape))
                         for name, es, ef in seen}),
        "calls": len(seen), "bytes": sum(unique.values()), "flash": flash})


KINDS = {"train": run_train, "eval": run_eval, "search": run_search,
         "head_mean": run_head_mean,
         "attention": run_attention, "trainer": run_trainer,
         "decoder": run_decoder, "continuous": run_continuous,
         "slot_engine": run_slot_engine, "serve": run_serve,
         "pipeline": run_pipeline, "saved": run_saved}


def main() -> int:
    workdir = sys.argv[1]
    torch.set_num_threads(1)
    layout = distributed.initialize(device="cpu")
    rank = layout.rank
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    for case in job["cases"]:
        hps = HParams(device="cpu", **case["hps"])
        hps.validate()
        KINDS[case["kind"]](case, hps, workdir, rank)
        distributed.barrier(case["name"])
    with open(os.path.join(workdir, f"done.rank{rank}"), "w") as f:
        f.write(json.dumps({"backend": distributed.backend(),
                            "ranks_per_device":
                                layout.ranks_per_device}))
    distributed.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
