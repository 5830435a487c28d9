"""Length-prefixed chunk files of serialized tf.Example records.

A copy of the part of the JAX package's data/chunks.py and
data/tfexample.py that the port's paths need: each record is an 8-byte
little-endian signed length followed by that many bytes of a serialized
``tf.train.Example`` (reference data.py:108-141 reader,
make_datafiles.py:150-209 writer).  Only bytes features are encoded and
decoded (``article`` and ``abstract`` are all the batcher reads); a
feature is a ``{name: [bytes or str, ...]}`` entry of a dict, so
``read_chunk_file`` gives back what ``write_chunk_file`` was given.
"""

from __future__ import annotations

import glob
import struct
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple, Union

_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_I32 = 0, 1, 2, 5

Features = Dict[str, Sequence[Union[bytes, str]]]


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, (field << 3) | _WIRE_LEN)
    _write_varint(out, len(payload))
    out.extend(payload)


def serialize_bytes_features(features: Features) -> bytes:
    """One tf.Example of bytes_list features, in the dict's order
    (tfexample.py:36-104 and Example.serialize): Example{features=1} ->
    Features{map feature=1} -> Feature{bytes_list=1} -> BytesList{value=1}.
    An empty list encodes as an empty bytes_list."""
    feats = bytearray()
    for key, values in features.items():
        blist = bytearray()
        for v in values:
            _write_len_delimited(blist, 1,
                                 v.encode("utf-8") if isinstance(v, str)
                                 else bytes(v))
        feature = bytearray()
        _write_len_delimited(feature, 1, bytes(blist))
        entry = bytearray()
        _write_len_delimited(entry, 1, key.encode("utf-8"))
        _write_len_delimited(entry, 2, bytes(feature))
        _write_len_delimited(feats, 1, bytes(entry))
    out = bytearray()
    _write_len_delimited(out, 1, bytes(feats))
    return bytes(out)


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


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field_number, wire_type, value) triples of one message body."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire in (_WIRE_LEN, _WIRE_I64, _WIRE_I32):
            if wire == _WIRE_LEN:
                ln, pos = _read_varint(buf, pos)
            else:
                ln = 8 if wire == _WIRE_I64 else 4
            if pos + ln > len(buf):
                raise ValueError("truncated field")
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_bytes_features(data: bytes) -> Dict[str, List[bytes]]:
    """The bytes_list features of one serialized tf.Example
    (Example{features=1} -> Features{map feature=1} -> Feature{bytes_list=1}
    -> BytesList{value=1}); float and int64 features are skipped."""
    out: Dict[str, List[bytes]] = {}
    for field, wire, feats in _iter_fields(data):
        if field != 1 or wire != _WIRE_LEN:
            continue
        for f2, w2, entry in _iter_fields(feats):
            if f2 != 1 or w2 != _WIRE_LEN:
                continue
            key, body = "", b""
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    body = v3
            for f4, w4, v4 in _iter_fields(body):
                if f4 == 1 and w4 == _WIRE_LEN:
                    out[key] = [v for f5, _, v in _iter_fields(v4) if f5 == 1]
    return out


def read_chunk_file(path: str) -> Iterator[Dict[str, List[bytes]]]:
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
            yield parse_bytes_features(blob)


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
                article = (feats.get("article") or [b""])[0].decode(
                    "utf-8", errors="replace")
                abstract = (feats.get("abstract") or [b""])[0].decode(
                    "utf-8", errors="replace")
                if article:
                    found = True
                    yield article, abstract
        if single_pass:
            return
        if not found:  # a repeated pass would spin forever on nothing
            raise ValueError(f"no record with an article under {data_path}")
