"""Length-prefixed chunk files of serialized tf.Example records.

A copy of the part of the JAX package's data/chunks.py that the port's
paths need: each record is an 8-byte little-endian signed length
followed by that many bytes of a serialized ``tf.train.Example``
(reference data.py:108-141 reader, make_datafiles.py:150-209 writer),
encoded and decoded by data/tfexample.py.  A record is a
``{name: [values]}`` dict of features, so ``read_chunk_file`` gives back
what ``write_chunk_file`` was given (bytes for str).
"""

from __future__ import annotations

import glob
import struct
from typing import Dict, Iterable, Iterator, Tuple

from textsummarization_on_flink_tpu_torch.data.tfexample import (
    Example,
    FeatureValue,
)

Features = Dict[str, FeatureValue]


def serialize_bytes_features(features: Features) -> bytes:
    """One serialized tf.Example of the features, in the dict's order
    (byte for byte the JAX package's Example.serialize)."""
    return Example(features).serialize()


def write_chunk_file(path: str, examples: Iterable[Features]) -> int:
    """Write examples to one chunk file (chunks.py:18); returns the record
    count."""
    n = 0
    with open(path, "wb") as f:
        for ex in examples:
            blob = serialize_bytes_features(ex)
            f.write(struct.pack("<q", len(blob)))
            f.write(blob)
            n += 1
    return n


def read_chunk_file(path: str) -> Iterator[Features]:
    with open(path, "rb") as f:
        while True:
            len_bytes = f.read(8)
            if not len_bytes:
                break
            if len(len_bytes) != 8:
                raise ValueError(f"truncated length prefix in {path}")
            (str_len,) = struct.unpack("<q", len_bytes)
            if str_len < 0:
                raise ValueError(f"truncated record in {path}")
            blob = f.read(str_len)
            if len(blob) != str_len:
                raise ValueError(f"truncated record in {path}")
            yield Example.parse(blob).features


def text_pairs(data_path: str, single_pass: bool = True,
               ) -> Iterator[Tuple[str, str]]:
    """(article, abstract) strings of every record under the glob, files
    in sorted order (data.py:108-141); records with an empty article are
    skipped, as the reference does.  single_pass: one pass; otherwise the
    file list is read again and again, forever (the JAX package shuffles
    it each pass, chunks.py:114-123; the port keeps file order,
    ROADMAP.md queue 1, item 3)."""
    while True:
        filelist = sorted(glob.glob(data_path))
        if not filelist:
            raise FileNotFoundError(f"Error: Empty filelist at {data_path}")
        found = False
        for path in filelist:
            for feats in read_chunk_file(path):
                ex = Example(feats)
                article = ex.get_str("article")
                abstract = ex.get_str("abstract")
                if article:
                    found = True
                    yield article, abstract
        if single_pass:
            return
        if not found:  # a repeated pass would spin forever on nothing
            raise ValueError(f"no record with an article under {data_path}")
