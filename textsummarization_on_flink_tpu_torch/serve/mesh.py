"""Serving on a (dp, tp, sp) mesh: the followers' loop.

A mesh server (serve/server.py over a sharded decoder; JAX serves a
sharded decoder from one process, the port runs one process per rank)
is built on every rank.  The chief runs the server as on one rank: the
queue, the front door, the batchers, the futures and the obs plane are
its alone.  Its dispatch thread is the only thread that issues
collectives: each dispatch sends its op down the chief's command stream
(parallel/collectives.command, through ``BeamSearchDecoder.lead``):

  * ``("decode",)``: a micro-batch ``decode_batch`` through the sharded
    beam search (the batch's arrays follow as the search's broadcast);
  * ``("engine", op, ...)``: a slot engine op (prefill, pack, step,
    unpack, release; decode/decoder.SlotDecodeEngine);
  * ``("reload", path)``: a checkpoint reload or hot swap, every rank
    loading the chief's path;
  * ``("stop",)``: the end of the stream (the chief's dispatch thread
    sends it when it leaves, after a ``stop()``, a ``kill()`` or a
    failed start).

Every other rank calls ``follow`` (``ServingServer.follow``), which runs
those ops in the order sent and returns at the stop.  A follower decides
nothing from its own clock: the batchers' timing, deadlines, the front
door's hits and sheds and the reload cadence are the chief's, and issue
no collective.  An op that fails on one rank fails on every rank
(collectives.all_ok); a follower logs it and takes the next op.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from textsummarization_on_flink_tpu_torch.parallel import collectives

log = logging.getLogger(__name__)


def follow(decoder: Any, engine: Optional[Any] = None) -> int:
    """Run the chief's ops on this rank until its stop; returns the number
    of ops run.  ``decoder``: this rank's sharded BeamSearchDecoder;
    ``engine``: its slot engine (continuous mode)."""
    plan = decoder.plan
    decoder.led = True
    n = 0
    while True:
        cmd = collectives.command(plan)
        op = cmd[0]
        if op == "stop":
            log.info("rank %d: the chief's stop after %d op(s)", plan.rank,
                     n)
            return n
        try:
            if op == "decode":
                decoder.decode_batch(None, tier="beam")
            elif op == "engine":
                engine.apply(cmd[1:])
            elif op == "reload":
                decoder.reload(cmd[1])
            else:
                raise ValueError(f"unknown mesh op {op!r}")
        except Exception:  # tslint: disable=TS005 — the chief raised the same op's error (collectives.all_ok) and resolves its requests; the follower takes the next op
            log.exception("rank %d: mesh op %r failed", plan.rank, cmd[:2])
        n += 1
