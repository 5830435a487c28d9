"""Hierarchical streaming summarizer — map-reduce long documents over
the serving fleet (SERVING.md "Hierarchical
summarization").

A copy of the JAX package's serve/hiersum.py (the port imports nothing
of that package).

A plain serving stack answers one question per request: "give
me the summary of THIS article" — and every article is implicitly
bounded by ``T_enc``.  The Flink heritage promises streaming *document*
summarization (PAPER.md §0), where a document grows on a topic without
bound.  This module closes that gap with a two-level map-reduce over
the EXISTING submit surface:

  map:    split the document into overlap-aware word chunks, key each
          chunk by the front door's canonical ``article_key()``, and
          fan every chunk through ``submit()`` as its own sub-request
          (``ServingServer`` or ``FleetRouter`` — anything with the
          submit surface).  In continuous mode each chunk rides the
          bucketed prefill, so a short tail chunk never pays the
          full-width encode.
  reduce: when the last chunk summary lands, concatenate the chunk
          summaries (decode/reduce.py budgets the words so every chunk
          keeps representation inside ``max_enc_steps``) and submit ONE
          more request on the reduce tier (beam by default) whose
          output is the document's summary.

The incremental lever — FastSeq's "never do redundant work" applied at
document granularity (PAPERS.md): chunk boundaries are a pure function
of word INDEX (stride = chunk - overlap), so appending to an open
``DocumentSession`` leaves every previously-complete chunk
byte-identical.  Resubmitted through the armed front door those chunks
cache-hit (or coalesce onto in-flight twins) and resolve synchronously
at submit — only the appended tail chunks and one reduce pass ever
decode.  Deduplication by construction, not by policy.

Tracing: ONE parent ``TraceContext`` is minted per document and a
``.child()`` of it threads through every chunk and the reduce
sub-request, so the whole fan-out tree reconstructs from events.jsonl
(``scripts/trace_summary.py --request <parent uuid>`` renders the
chunk children indented under the parent).  Two new lifecycle events:
``hier_chunk`` (per chunk, after submit — carries chunk index, key,
bucket, tier, cache_hit) and ``hier_reduce`` (the reduce submit).

Failure contract (tests/test_hiersum.py chaos case): a failed chunk
sub-request fails TYPED and alone; the parent future waits for every
outstanding chunk to resolve (no orphaned chunk futures), then rejects
exactly once with ``HierPartialFailureError`` naming the failed chunk
indices and their causes.  The reduce pass is never submitted over a
partial map.

Quality check (guided-attention lesson, PAPERS.md): the reduce output
is scored for n-gram containment against the chunk summaries it read
and against the source chunks (``serve/hier_copy_fidelity`` histogram)
— a reduce pass that hallucinates past its inputs shows up as a
low-fidelity bucket, not a silent quality cliff.

Import-light: no torch — chunking, fan-out bookkeeping, and fidelity are
pure Python over the submit surface (the same discipline as queue.py /
frontdoor.py).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch import config
from textsummarization_on_flink_tpu_torch.decode.reduce import (
    assemble_reduce_input,
)
from textsummarization_on_flink_tpu_torch.obs import locksan
from textsummarization_on_flink_tpu_torch.serve.errors import (
    HierPartialFailureError,
)
from textsummarization_on_flink_tpu_torch.serve.frontdoor import article_key
from textsummarization_on_flink_tpu_torch.serve.queue import ServeFuture

log = logging.getLogger(__name__)

#: fidelity is a ratio in [0, 1]; latency-shaped exponential buckets
#: would dump every observation into one bin
FIDELITY_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0)

#: fan-out width per document (chunks); documents past the last bucket
#: land in +Inf — the histogram is for shape, the exact count rides the
#: hier_reduce event's ``chunks`` attr
FANOUT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


def chunk_document(article: str, chunk_words: int,
                   overlap_words: int = 0) -> List[str]:
    """Split `article` into overlap-aware word chunks.

    Chunk i covers words ``[i*stride, i*stride + chunk_words)`` with
    ``stride = chunk_words - overlap_words`` — boundaries are a pure
    function of word index, never of document length.  That property IS
    the append-path cache lever: growing the document leaves every
    chunk that was already complete (``start + chunk_words <= old_len``)
    byte-identical, so its ``article_key()`` — and therefore its front
    door cache entry — still matches.  Only a previously-TRUNCATED tail
    chunk (and chunks past the old end) change.

    The last chunk always reaches the document's end (it may be shorter
    than ``chunk_words``); an empty/whitespace article yields [].
    """
    if chunk_words < 1:
        raise ValueError(f"chunk_words must be >= 1, got {chunk_words}")
    if not 0 <= overlap_words < chunk_words:
        raise ValueError(
            f"overlap_words must be in [0, chunk_words={chunk_words}), "
            f"got {overlap_words}")
    words = article.split()
    if not words:
        return []
    stride = chunk_words - overlap_words
    chunks: List[str] = []
    start = 0
    while True:
        chunks.append(" ".join(words[start:start + chunk_words]))
        if start + chunk_words >= len(words):
            return chunks
        start += stride


def ngram_containment(words: Sequence[str],
                      sources: Sequence[Sequence[str]],
                      n: int = 2) -> float:
    """Fraction of `words`' n-grams present in the union of `sources`'
    n-grams — the copy-fidelity score of a reduce output against what
    it was allowed to read.  Falls back to unigrams for texts shorter
    than `n`; empty inputs score 1.0 (nothing was fabricated)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")

    def grams(ws: Sequence[str], k: int) -> List[Tuple[str, ...]]:
        return [tuple(ws[i:i + k]) for i in range(len(ws) - k + 1)]

    k = min(n, len(words)) or 1
    target = grams(list(words), k)
    if not target:
        return 1.0
    pool = set()
    for src in sources:
        pool.update(grams(list(src), k))
    return sum(1 for g in target if g in pool) / len(target)


class DocumentSession:
    """One open document stream: the text so far + the chunk keys of
    the last summarize, so a re-summarize after ``append()`` can report
    exactly how many chunks were reusable (the front door does the
    actual dedup — this is the bookkeeping that makes it observable and
    pinnable in tests).  Sessions are driver-side state: one per
    streaming doc id in the pipeline stage (estimator.py)."""

    __slots__ = ("doc_id", "text", "revision", "chunk_keys")

    def __init__(self, doc_id: str, text: str = ""):
        self.doc_id = doc_id
        self.text = text
        #: completed summarize passes over this stream (rides the
        #: parent uuid: ``<doc_id>@r<revision>``)
        self.revision = 0
        #: per-chunk ``article_key`` list as of the last summarize
        self.chunk_keys: List[str] = []

    def append(self, text: str) -> "DocumentSession":
        """Extend the stream (word-level concatenation — the framing
        layer has already joined parts with whitespace)."""
        text = text.strip()
        if text:
            self.text = f"{self.text} {text}".strip()
        return self


class HierResult:
    """The parent request's resolution payload: the reduce summary
    re-keyed to the DOCUMENT (uuid/article/reference of the caller's
    request, not the reduce sub-request's).  A fresh object per
    document — the reduce ``DecodedResult`` may be a shared front-door
    cache payload and must never be mutated."""

    __slots__ = ("uuid", "article", "reference", "decoded_words",
                 "chunk_count", "reused_chunks", "copy_fidelity",
                 "degraded")

    def __init__(self, uuid: str, article: str, reference: str,
                 decoded_words: List[str], chunk_count: int,
                 reused_chunks: int, copy_fidelity: float,
                 degraded: bool = False):
        self.uuid = uuid
        self.article = article
        self.reference = reference
        self.decoded_words = decoded_words
        self.chunk_count = chunk_count
        self.reused_chunks = reused_chunks
        #: n-gram containment of the summary vs the chunk summaries
        self.copy_fidelity = copy_fidelity
        self.degraded = degraded

    @property
    def summary(self) -> str:
        return " ".join(self.decoded_words)

    def as_row(self) -> Tuple[str, str, str, str]:
        """The pipeline output row (uuid, article, summary, reference) —
        same shape as DecodedResult.as_row()."""
        return (self.uuid, self.article, self.summary, self.reference)


class _FanOut:
    """Bookkeeping for one document's in-flight map-reduce: chunk
    results land by index under a lock; the LAST chunk's resolution
    (and only it) advances to the reduce submit or the typed partial
    rejection.  The parent future resolves exactly once because every
    path out of here funnels through it exactly once."""

    __slots__ = ("uuid", "article", "reference", "tenant", "parent",
                 "ctx", "chunks", "results", "errors", "remaining",
                 "reused", "lock")

    def __init__(self, uuid: str, article: str, reference: str,
                 tenant: str, parent: ServeFuture,
                 ctx: Optional[obs.TraceContext], chunks: List[str],
                 reused: int):
        self.uuid = uuid
        self.article = article
        self.reference = reference
        self.tenant = tenant
        self.parent = parent
        self.ctx = ctx
        self.chunks = chunks
        self.results: List[Optional[Any]] = [None] * len(chunks)
        self.errors: Dict[int, BaseException] = {}
        #: chunks not yet resolved — set to the FULL width before any
        #: submit, so a synchronously-resolving cache hit mid-loop can
        #: never see a premature zero
        self.remaining = len(chunks)
        self.reused = reused
        self.lock = locksan.make_lock("HierFanOut._lock")


class HierarchicalSummarizer:
    """Map-reduce document summarization over an existing submit
    surface (``ServingServer`` or ``FleetRouter``).

    ``summarize()`` returns a ``ServeFuture`` resolving to a
    ``HierResult`` — the caller blocks (or attaches callbacks) exactly
    as for a plain submit.  The summarizer owns no threads: chunk
    completions drive the reduce submit from the server's own resolve
    callbacks, so the tick-driven virtual-time gate
    (tests/test_serve_slo.py "hierarchical") replays it deterministically
    on a single thread.

    Tier policy: chunks decode on ``hps.hier_chunk_tier`` (greedy by
    default — cheap extractive passes), the reduce on
    ``hps.hier_reduce_tier`` (beam — the caller-visible quality).  A
    continuous-mode surface decodes beam-only by construction
    (server.py submit validation), so both collapse to beam there — the
    fan-out win comes from slot parallelism + bucketed prefill instead
    of tier pricing.
    """

    def __init__(self, server: Any, hps: "config.HParams",
                 registry: Optional[obs.Registry] = None):
        self._server = server
        self._hps = hps
        self._reg = registry if registry is not None \
            else obs.registry_for(hps)
        self._chunk_words = config.resolve_hier_chunk_words(hps)
        self._overlap = hps.hier_overlap_words
        mode = getattr(server, "serve_mode", "") \
            or getattr(hps, "serve_mode", "microbatch")
        self._chunk_tier = "beam" if mode == "continuous" \
            else (hps.hier_chunk_tier or "greedy")
        self._reduce_tier = "beam" if mode == "continuous" \
            else (hps.hier_reduce_tier or "beam")
        self._buckets = config.parse_bucket_spec(
            getattr(hps, "serve_buckets", ""), hps.max_enc_steps)
        # construction-time metric handles (the cached-sibling idiom of
        # every serve hot path: no registry lock on the per-chunk path)
        self._c_docs = self._reg.counter("serve/hier_documents_total")
        self._c_chunks = self._reg.counter("serve/hier_chunks_total")
        self._c_reused = self._reg.counter("serve/hier_chunks_reused_total")
        self._c_chunk_hits = self._reg.counter(
            "serve/hier_chunk_cache_hits_total")
        self._c_reduce = self._reg.counter("serve/hier_reduce_total")
        self._c_partial = self._reg.counter(
            "serve/hier_partial_failures_total")
        self._h_fanout = self._reg.histogram(
            "serve/hier_fanout_chunks", buckets=FANOUT_BUCKETS)
        self._h_fidelity = self._reg.histogram(
            "serve/hier_copy_fidelity", buckets=FIDELITY_BUCKETS)

    # -- public API --

    def summarize(self, article: str, uuid: str = "", reference: str = "",
                  session: Optional[DocumentSession] = None,
                  tenant: str = "", block: bool = False,
                  timeout: Optional[float] = None) -> ServeFuture:
        """Fan one document out chunk-by-chunk and return the parent
        future (resolves to a ``HierResult`` when the reduce lands, or
        rejects typed).

        With a ``session``, the DOCUMENT IS THE SESSION's accumulated
        text (`article` must be empty — append first, then summarize),
        the parent uuid defaults to ``<doc_id>@r<N>``, and the session's
        chunk keys from the previous pass pin how many chunks were
        reusable this pass (``serve/hier_chunks_reused_total``).

        ``block=True`` applies pipeline backpressure per chunk submit
        (the transform path); the default sheds typed on a full queue
        exactly like a plain submit."""
        if session is not None:
            if article:
                raise ValueError(
                    "summarize(session=...) reads the session's text; "
                    "append() new content instead of passing article=")
            article = session.text
            session.revision += 1
            if not uuid:
                uuid = f"{session.doc_id}@r{session.revision}"
        if not uuid:
            uuid = f"hier-{article_key(article, self._hps.max_enc_steps)}"
        chunks = chunk_document(article, self._chunk_words, self._overlap)
        if not chunks:
            raise ValueError(
                f"document {uuid!r} has no words to summarize")
        keys = [article_key(c, self._hps.max_enc_steps) for c in chunks]
        reused = 0
        if session is not None:
            reused = sum(1 for old, new in zip(session.chunk_keys, keys)
                         if old == new)
            session.chunk_keys = keys
        self._c_docs.inc()
        self._c_chunks.inc(len(chunks))
        if reused:
            self._c_reused.inc(reused)
        self._h_fanout.observe(float(len(chunks)))
        # ONE parent context per document; every chunk and the reduce
        # submit a .child() of it, so the whole fan-out shares one
        # trace_id with parent_id -> parent span linkage (the tree
        # trace_summary.py --request renders)
        ctx = obs.TraceContext.new() if self._reg.enabled else None
        parent = ServeFuture(uuid, registry=self._reg)
        parent.trace = ctx
        # scope-tag the parent's terminal resolve (the fleet idiom):
        # the chunk sub-requests resolve in the same trace, and the
        # timeline's total_ms must key on the DOCUMENT's resolution
        parent.scope = "hier"
        fo = _FanOut(uuid, article, reference, tenant, parent, ctx,
                     chunks, reused)
        self._fan_out(fo, keys, block=block, timeout=timeout)
        return parent

    # -- fan-out / reduce driver --

    def _fan_out(self, fo: _FanOut, keys: List[str], block: bool,
                 timeout: Optional[float]) -> None:
        """Submit every chunk as its own sub-request.  A submit that
        raises (overload, closed, tier validation) fails THAT chunk and
        every not-yet-submitted one with the same typed cause — the
        in-flight chunks still drain before the parent rejects, so no
        chunk future is ever orphaned."""
        n = len(fo.chunks)
        for i, chunk in enumerate(fo.chunks):
            child = fo.ctx.child() if fo.ctx is not None else None
            chunk_uuid = f"{fo.uuid}/c{i}"
            words = len(chunk.split())
            try:
                fut = self._server.submit(
                    chunk, uuid=chunk_uuid, reference="", block=block,
                    timeout=timeout, tier=self._chunk_tier, trace=child,
                    tenant=fo.tenant)
            except BaseException as e:  # tslint: disable=TS005 — not swallowed: the typed cause fails THIS and every unsubmitted chunk via _record_chunk and rejects the parent as HierPartialFailureError
                log.warning("hier chunk submit failed for %s (%d..%d "
                            "of %d): %s", fo.uuid, i, n - 1, n, e)
                for j in range(i, n):
                    self._record_chunk(fo, j, None, e)
                return
            # the front door's cache answered it at submit (a coalesced
            # follower resolves later, with its leader) — the flag the
            # append-path pins ride.  The JAX package reads fut.done()
            # here, which also counts a chunk whose decode finished
            # before this line ran (a fast decoder on a loaded host)
            hit = fut.cache_hit
            if hit:
                self._c_chunk_hits.inc()
            obs.spans.request_event(
                self._reg, "hier_chunk", child, chunk_uuid,
                parent_uuid=fo.uuid, chunk=i, chunks=n, key=keys[i],
                words=words,
                bucket=config.bucket_for(
                    self._buckets, min(words, self._hps.max_enc_steps)),
                tier=self._chunk_tier, cache_hit=hit)
            fut.add_done_callback(
                lambda f, idx=i: self._chunk_done(fo, idx, f))

    def _chunk_done(self, fo: _FanOut, idx: int, fut: ServeFuture) -> None:
        """One chunk resolved (any thread).  Runs inside the server's
        resolve callback — must stay cheap and must not block."""
        if fut.error is not None:
            self._record_chunk(fo, idx, None, fut.error)
        else:
            self._record_chunk(fo, idx, fut.result(timeout=0), None)

    def _record_chunk(self, fo: _FanOut, idx: int, result: Any,
                      error: Optional[BaseException]) -> None:
        with fo.lock:
            if error is not None:
                fo.errors[idx] = error
            else:
                fo.results[idx] = result
            fo.remaining -= 1
            last = fo.remaining == 0
        if last:
            self._map_complete(fo)

    def _map_complete(self, fo: _FanOut) -> None:
        """Every chunk future has resolved (success or typed failure):
        either submit the reduce pass or reject the parent with the
        typed partial-failure verdict.  Exactly one of the two runs —
        the caller is the unique remaining==0 transition."""
        if fo.errors:
            self._c_partial.inc()
            fo.parent._reject(HierPartialFailureError(
                fo.uuid, dict(fo.errors), len(fo.chunks)))
            return
        summaries = [list(getattr(r, "decoded_words", []) or [])
                     for r in fo.results]
        reduce_input = assemble_reduce_input(
            summaries, self._hps.max_enc_steps)
        child = fo.ctx.child() if fo.ctx is not None else None
        reduce_uuid = f"{fo.uuid}/reduce"
        self._c_reduce.inc()
        try:
            fut = self._server.submit(
                reduce_input, uuid=reduce_uuid, reference=fo.reference,
                block=False, tier=self._reduce_tier, trace=child,
                tenant=fo.tenant)
        except BaseException as e:
            self._c_partial.inc()
            fo.parent._reject(HierPartialFailureError(
                fo.uuid, {"reduce": e}, len(fo.chunks)))
            return
        hit = fut.cache_hit
        obs.spans.request_event(
            self._reg, "hier_reduce", child, reduce_uuid,
            parent_uuid=fo.uuid, chunks=len(fo.chunks),
            words=len(reduce_input.split()), tier=self._reduce_tier,
            cache_hit=hit)
        fut.add_done_callback(lambda f: self._reduce_done(fo, f))

    def _reduce_done(self, fo: _FanOut, fut: ServeFuture) -> None:
        if fut.error is not None:
            self._c_partial.inc()
            fo.parent._reject(HierPartialFailureError(
                fo.uuid, {"reduce": fut.error}, len(fo.chunks)))
            return
        res = fut.result(timeout=0)
        words = list(getattr(res, "decoded_words", []) or [])
        summaries = [list(getattr(r, "decoded_words", []) or [])
                     for r in fo.results]
        # the guided-attention check in measurable form: how much of
        # the reduce output is grounded in what it was allowed to read —
        # the chunk summaries it decoded from AND the source chunks
        # (an extractive reduce that copies source spans verbatim is
        # faithful, not fabricated)
        pool = summaries + [c.split() for c in fo.chunks]
        fidelity = ngram_containment(words, pool)
        self._h_fidelity.observe(fidelity)
        fo.parent._resolve(HierResult(
            fo.uuid, fo.article, fo.reference, words,
            chunk_count=len(fo.chunks), reused_chunks=fo.reused,
            copy_fidelity=fidelity,
            degraded=bool(getattr(res, "degraded", False))))


__all__ = ["HierarchicalSummarizer", "DocumentSession", "HierResult",
           "chunk_document", "ngram_containment",
           "FIDELITY_BUCKETS", "FANOUT_BUCKETS"]
