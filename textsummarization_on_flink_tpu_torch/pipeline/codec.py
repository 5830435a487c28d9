"""Row <-> tf.Example wire codec driven by schemas (CodingUtils parity).

The port's copy of the row coding of the JAX package's
pipeline/codec.py.  The reference configures Flink-AI-Extended's
``ExampleCoding`` from table schemas (CodingUtils.java): each side of the
Java<->Python data plane gets an encode and/or decode config derived from
the column names and types (:131-145), with null schemas tolerated on
either side (:196-206).  Here the data plane is the pipeline's bridge
to the trainer or decoder, and the wire format is the same serialized
tf.Example (data/tfexample.py).  Types follow CodingUtils.java:25-129:
ints (and BOOL as 0/1) ride the int64 list, floats the float list,
STRING the bytes list, FLOAT_32_ARRAY a multi-valued float list.

It also keeps the JAX codec's multi-row document framing
(``frame_document_rows``, ``parse_document_frame``, ``DocumentAssembler``)
that carries a long document to ``transform(hierarchical=True)``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch.data.tfexample import Example
from textsummarization_on_flink_tpu_torch.pipeline.io import (
    DataTypes,
    Row,
    RowSchema,
)


def encode_row(schema: RowSchema, row: Row) -> bytes:
    """Row -> serialized tf.Example (ExampleCodingConfig.createRowToExample)."""
    if len(row) != len(schema):
        raise ValueError(f"row arity {len(row)} != schema arity {len(schema)}")
    ex = Example()
    for name, typ, val in zip(schema.names, schema.types, row):
        if typ == DataTypes.STRING:
            ex.set_bytes(name, str(val).encode("utf-8"))
        elif typ in DataTypes._INTS:
            ex.set_ints(name, int(val))
        elif typ in DataTypes._FLOATS:
            ex.set_floats(name, float(val))
        elif typ == DataTypes.FLOAT_32_ARRAY:
            ex.set_floats(name, *[float(v) for v in val])
        else:  # pragma: no cover - RowSchema validates its types
            raise ValueError(f"Unsupported data type for example coding: {typ}")
    return ex.serialize()


def decode_example(schema: RowSchema, data: bytes) -> Row:
    """Serialized tf.Example -> Row in schema column order."""
    ex = Example.parse(data)
    out: List = []
    for name, typ in zip(schema.names, schema.types):
        vals = ex.features.get(name, [])
        if typ == DataTypes.STRING:
            out.append(ex.get_str(name))
        elif typ == DataTypes.BOOL:
            out.append(bool(vals[0]) if vals else False)
        elif typ in DataTypes._INTS:
            out.append(int(vals[0]) if vals else 0)
        elif typ in DataTypes._FLOATS:
            out.append(float(vals[0]) if vals else 0.0)
        elif typ == DataTypes.FLOAT_32_ARRAY:
            out.append([float(v) for v in vals])
        else:  # pragma: no cover
            raise ValueError(f"Unsupported data type for example coding: {typ}")
    return tuple(out)


class ExampleCoding:
    """Both directions with the null-schema tolerance of
    CodingUtils.configureExampleCoding (:196-206): a missing input schema
    disables encoding, a missing output schema disables decoding, and
    rows then pass through untouched."""

    def __init__(self, input_schema: Optional[RowSchema],
                 output_schema: Optional[RowSchema]):
        self.input_schema = input_schema
        self.output_schema = output_schema

    def encode(self, row: Row):
        if self.input_schema is None:
            return row  # pass-through (encode not configured)
        return encode_row(self.input_schema, row)

    def decode(self, data):
        if self.output_schema is None:
            return data  # pass-through (decode not configured)
        return decode_example(self.output_schema, data)


# --------------------------------------------------------------------------
# Multi-row document framing
#
# The row wire format caps practical article size at one row's payload; a
# long document rides the SAME transport as N framed rows whose uuids carry
# the reassembly key: "{doc}#{i}/{n}" with 1-based part index i.  Framing is
# TRANSPORT, not summarization — frame width has no semantic meaning, while
# hiersum's chunk width does (overlap, cache keys).  The assembler therefore
# re-joins the full article before the hierarchical stage re-chunks it.

_FRAME_RE = re.compile(r"^(?P<doc>.+)#(?P<i>\d+)/(?P<n>\d+)$")


class DocumentFramingError(ValueError):
    """A framed row violates the reassembly contract (inconsistent total,
    duplicate or out-of-range part index).  A corrupt frame stream must
    fail the job, not emit a silently-truncated document — the same
    poisoned-stream stance as the codec itself."""


def parse_document_frame(uuid: str) -> Optional[Tuple[str, int, int]]:
    """"doc#i/n" -> (doc, i, n) with 1-based i; None for unframed uuids.
    Zero/overflowing indices are NOT silently unframed — a uuid that looks
    framed but is malformed is an error the assembler raises on."""
    m = _FRAME_RE.match(uuid)
    if m is None:
        return None
    return m.group("doc"), int(m.group("i")), int(m.group("n"))


def frame_document_rows(uuid: str, article: str, reference: str,
                        frame_words: int) -> List[Row]:
    """Producer-side split of one document into framed
    (uuid, article, reference) rows of at most ``frame_words`` words each.
    The reference rides only the first frame (the assembler takes the
    first non-empty one); a document that fits one frame still gets the
    "#1/1" suffix so append frames for the same doc id compose."""
    if frame_words < 1:
        raise ValueError(f"frame_words must be >= 1, got {frame_words}")
    words = article.split()
    if not words:
        raise ValueError(f"document {uuid!r} has no words to frame")
    parts = [words[i:i + frame_words]
             for i in range(0, len(words), frame_words)]
    n = len(parts)
    return [(f"{uuid}#{i + 1}/{n}", " ".join(p),
             reference if i == 0 else "")
            for i, p in enumerate(parts)]


class DocumentAssembler:
    """Streaming reassembly of framed rows into whole-document rows.

    ``feed(row)`` buffers framed parts per doc id and returns the
    completed (doc_id, article, reference) row when the last part lands;
    unframed rows pass through unchanged (mixed streams are legal —
    framing is opt-in per document).  Parts may arrive out of order
    WITHIN a document (the buffer is index-keyed); what raises is
    contract violation: a part total disagreeing with earlier frames of
    the same doc, a duplicate index, or an index outside 1..n — each
    counted in ``pipeline/codec_errors_total`` before raising, so the
    poisoned-stream metric covers framing corruption too.

    A doc id may complete MORE than once: each completed frame-set is
    one revision, and the hierarchical stage treats revisions after the
    first as appended text (pipeline/estimator.py)."""

    def __init__(self, registry=None):
        from textsummarization_on_flink_tpu_torch import obs

        self._reg = registry if registry is not None else obs.registry()
        self._c_err = self._reg.counter("pipeline/codec_errors_total")
        # doc -> (total, {index: article part}, reference)
        self._parts: Dict[str, Tuple[int, Dict[int, str], str]] = {}

    def _fail(self, msg: str) -> None:
        self._c_err.inc()
        raise DocumentFramingError(msg)

    def feed(self, row: Row) -> Optional[Row]:
        uuid, article, reference = str(row[0]), str(row[1]), str(row[2])
        frame = parse_document_frame(uuid)
        if frame is None:
            return row
        doc, i, n = frame
        if n < 1 or not (1 <= i <= n):
            self._fail(f"frame {uuid!r}: index {i} outside 1..{n}")
        total, buf, ref = self._parts.get(doc, (n, {}, ""))
        if total != n:
            self._fail(f"frame {uuid!r}: part total {n} != {total} "
                       f"seen earlier for doc {doc!r}")
        if i in buf:
            self._fail(f"frame {uuid!r}: duplicate part index")
        buf[i] = article
        if not ref and reference:
            ref = reference
        if len(buf) < n:
            self._parts[doc] = (total, buf, ref)
            return None
        # a single-frame doc completes without ever buffering; either
        # way the doc id may start a NEW frame-set (revision) after this
        self._parts.pop(doc, None)
        joined = " ".join(buf[k] for k in range(1, n + 1))
        return (doc, joined, ref)

    def pending(self) -> List[str]:
        """Doc ids with buffered but incomplete frame-sets — non-empty at
        natural stream end means a truncated stream (caller raises)."""
        return sorted(self._parts)
