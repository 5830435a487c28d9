"""Length-prefixed chunk files of serialized tf.Example records.

A copy of the part of the JAX package's data/chunks.py that the port's
paths need: each record is an 8-byte little-endian signed length
followed by that many bytes of a serialized ``tf.train.Example``
(reference data.py:108-141 reader, make_datafiles.py:150-209 writer),
encoded and decoded by data/tfexample.py.  A record is a
``{name: [values]}`` dict of features, so ``read_chunk_file`` gives back
what ``write_chunk_file`` was given (bytes for str).
``example_generator`` streams the records, and ``text_pairs`` their
non-empty (article, abstract) strings as the batcher reads them: the
files sorted and read once in single-pass mode, shuffled every pass
otherwise.  ``write_chunked_iter`` writes a stream of records into
numbered chunk files ``<prefix>_000.bin``, ... (the offline ETL's
writer, data/etl.py).
"""

from __future__ import annotations

import glob
import random
import struct
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

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


def chunk_path(prefix: str, index: int, total_chunks: int = 0) -> str:
    """The chunk-file naming of make_datafiles.py:42 (JAX chunks.py:130):
    ``<prefix>_NNN.bin``, at least 3 digits and enough that lexicographic
    order is numeric order."""
    width = max(3, len(str(max(total_chunks - 1, index))))
    return f"{prefix}_{index:0{width}d}.bin"


def write_chunked_iter(prefix: str, examples: Iterable[Features],
                       chunk_size: int = 1000,
                       total_chunks: int = 0) -> List[str]:
    """Write a stream of records into ``chunk_size``-record chunk files
    ``<prefix>_000.bin``, ... holding one chunk in memory at a time (JAX
    chunks.py:151; make_datafiles.py:36-64); an empty stream writes one
    empty file.  Returns the paths."""
    paths: List[str] = []
    pending: List[Features] = []

    def flush() -> None:
        path = chunk_path(prefix, len(paths), total_chunks)
        write_chunk_file(path, pending)
        paths.append(path)
        pending.clear()

    for ex in examples:
        pending.append(ex)
        if len(pending) >= chunk_size:
            flush()
    if pending or not paths:
        flush()
    return paths


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


def _one_pass(data_path: str, single_pass: bool,
              rng: random.Random) -> Iterator[Example]:
    """The records of one pass over the glob: files sorted in single_pass,
    shuffled by ``rng`` otherwise."""
    filelist = glob.glob(data_path)
    if not filelist:
        raise FileNotFoundError(f"Error: Empty filelist at {data_path}")
    if single_pass:
        filelist = sorted(filelist)
    else:
        rng.shuffle(filelist)
    for path in filelist:
        for feats in read_chunk_file(path):
            yield Example(feats)


def example_generator(data_path: str, single_pass: bool,
                      rng: Optional[random.Random] = None,
                      ) -> Iterator[Example]:
    """Examples of every record under the glob (data.py:108-141; JAX
    data/chunks.py:111-127).  single_pass: the files in sorted order,
    once.  Otherwise the file list is shuffled each pass by ``rng`` (a
    fresh ``random.Random()`` when None, never the global generator),
    forever; a pass that finds no record at all raises rather than spin."""
    rng = rng or random.Random()
    while True:
        found = False
        for ex in _one_pass(data_path, single_pass, rng):
            found = True
            yield ex
        if single_pass:
            return
        if not found:  # a repeated pass would spin forever on nothing
            raise ValueError(f"no record under {data_path}")


def text_pairs(data_path: str, single_pass: bool = True,
               rng: Optional[random.Random] = None,
               on_empty: Optional[Callable[[], None]] = None,
               ) -> Iterator[Tuple[str, str]]:
    """(article, abstract) strings of the records, passes as
    ``example_generator``'s.  Records with an empty article are skipped,
    as the reference does, calling ``on_empty`` for each; a streaming
    pass with no article at all raises rather than spin."""
    rng = rng or random.Random()
    while True:
        found = False
        for ex in _one_pass(data_path, single_pass, rng):
            article = ex.get_str("article")
            if not article:
                if on_empty is not None:
                    on_empty()
                continue
            found = True
            yield article, ex.get_str("abstract")
        if single_pass:
            return
        if not found:  # a repeated pass would spin forever on nothing
            raise ValueError(f"no record with an article under {data_path}")
