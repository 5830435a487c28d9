"""Reduce-pass input assembly for hierarchical summarization.

A copy of the JAX package's decode/reduce.py (the port imports nothing
of that package).

The reduce pass of serve/hiersum.py decodes ONE more request whose
encoder input is the concatenation of the per-chunk summaries.  That
input must fit the decode-side encoder horizon (``max_enc_steps``) —
and HOW it is truncated is a quality decision, not a formatting one:
naive head-truncation of the concatenation silently deletes the tail
chunks from the document's summary, which is exactly the
missing-coverage failure the cross-chunk copy-fidelity metric exists to
catch.  So the budgeting rule here keeps every chunk represented:

  * when everything fits, the summaries concatenate verbatim in chunk
    order (document order is meaning-bearing for news-style text);
  * when over budget, each chunk summary keeps an equal word budget
    (``max_words // n_chunks``, min 1) from its FRONT — summary-leading
    words carry the most content for this model family — and chunk
    order is preserved.

Lives in decode/ because it shapes the encoder input of a decode pass
(the reduce request is a plain submit; the serving layer neither knows
nor cares that its article was assembled).  Import-light: no torch — the
serve layer imports this on its hot path.
"""

from __future__ import annotations

from typing import List, Sequence


def assemble_reduce_input(chunk_summaries: Sequence[Sequence[str]],
                          max_words: int) -> str:
    """Concatenate per-chunk summary words into the reduce pass's
    article, budgeted so every chunk survives truncation (see module
    docstring).  Empty chunk summaries are skipped; an all-empty map
    yields "" (the caller treats that as a failed document rather than
    decoding an empty article)."""
    if max_words < 1:
        raise ValueError(f"max_words must be >= 1, got {max_words}")
    parts: List[List[str]] = [list(s) for s in chunk_summaries if s]
    if not parts:
        return ""
    total = sum(len(p) for p in parts)
    if total > max_words:
        budget = max(1, max_words // len(parts))
        parts = [p[:budget] for p in parts]
    words: List[str] = []
    for p in parts:
        words.extend(p)
    # the equal-budget floor of 1 word/chunk can still overflow for
    # extreme fan-outs (n_chunks > max_words); the hard cap keeps the
    # contract absolute and drops trailing chunks LAST
    return " ".join(words[:max_words])


__all__ = ["assemble_reduce_input"]
