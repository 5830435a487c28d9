"""Pure-Python tf.train.Example protobuf codec.

A copy of the JAX package's data/tfexample.py, the port's one proto
codec: chunk files (data/chunks.py) and the pipeline's row coding
(pipeline/codec.py) both go through it.  The reference's on-disk and
on-wire data format is the serialized ``tf.train.Example`` proto
(data.py:108-141 reads it; make_datafiles.py writes it; the
Flink<->python data plane ships it as bytes).  This module implements
just enough of the proto3 wire format to encode and decode that one
message family without TensorFlow or protoc-generated code:

    Example   { Features features = 1; }
    Features  { map<string, Feature> feature = 1; }
    Feature   { oneof kind { BytesList bytes_list = 1;
                             FloatList float_list = 2;
                             Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed = true]; }
    Int64List { repeated int64 value = 1 [packed = true]; }

Wire-compatible with TensorFlow's serialization (field numbers and types
from tensorflow/core/example/{example,feature}.proto).  The decoder
accepts both packed and unpacked repeated scalars.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Sequence, Tuple, Union

FeatureValue = Union[List[bytes], List[float], List[int]]

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


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
        if shift >= 70:
            raise ValueError("varint too long")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, _WIRE_LEN))
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_bytes_list(values: Sequence[bytes]) -> bytes:
    out = bytearray()
    for v in values:
        if isinstance(v, str):
            v = v.encode("utf-8")
        _write_len_delimited(out, 1, bytes(v))
    return bytes(out)


def _encode_float_list(values: Sequence[float]) -> bytes:
    out = bytearray()
    packed = struct.pack(f"<{len(values)}f", *values)
    _write_len_delimited(out, 1, packed)
    return bytes(out)


def _encode_int64_list(values: Sequence[int]) -> bytes:
    payload = bytearray()
    for v in values:
        _write_varint(payload, int(v))
    out = bytearray()
    _write_len_delimited(out, 1, bytes(payload))
    return bytes(out)


def _encode_feature(values: FeatureValue) -> bytes:
    out = bytearray()
    if not values:
        # ambiguous empty feature: encode as empty bytes_list
        _write_len_delimited(out, 1, b"")
        return bytes(out)
    head = values[0]
    if isinstance(head, (bytes, str)):
        _write_len_delimited(out, 1, _encode_bytes_list(values))  # type: ignore[arg-type]
    elif isinstance(head, float):
        _write_len_delimited(out, 2, _encode_float_list(values))  # type: ignore[arg-type]
    elif isinstance(head, int):
        _write_len_delimited(out, 3, _encode_int64_list(values))  # type: ignore[arg-type]
    else:
        raise TypeError(f"unsupported feature value type: {type(head)}")
    return bytes(out)


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value) triples from a message body."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > len(buf):
                raise ValueError("truncated length-delimited field")
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == _WIRE_I64:
            if pos + 8 > len(buf):
                raise ValueError("truncated fixed64 field")
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == _WIRE_I32:
            if pos + 4 > len(buf):
                raise ValueError("truncated fixed32 field")
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_scalar_list(buf: bytes, kind: str) -> FeatureValue:
    values: List = []
    for field, wire, val in _iter_fields(buf):
        if field != 1:
            continue
        if kind == "bytes":
            values.append(val)
        elif kind == "float":
            if wire == _WIRE_LEN:  # packed
                if len(val) % 4 != 0:
                    raise ValueError("truncated packed float list")
                values.extend(struct.unpack(f"<{len(val) // 4}f", val))
            elif wire == _WIRE_I32:
                values.append(struct.unpack("<f", val)[0])
        elif kind == "int64":
            if wire == _WIRE_VARINT:
                values.append(_signed64(val))
            elif wire == _WIRE_LEN:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    values.append(_signed64(v))
    return values


class Example:
    """A tf.train.Example: a named bag of bytes/float/int64 feature lists."""

    def __init__(self, features: Dict[str, FeatureValue] | None = None):
        self.features: Dict[str, FeatureValue] = dict(features or {})

    # -- convenience accessors (mirror example.features.feature[k] usage) --
    def bytes_list(self, key: str) -> List[bytes]:
        return list(self.features.get(key, []))  # type: ignore[arg-type]

    def get_bytes(self, key: str, index: int = 0, default: bytes = b"") -> bytes:
        vals = self.features.get(key)
        if not vals or index >= len(vals):
            return default
        v = vals[index]
        return v if isinstance(v, bytes) else str(v).encode("utf-8")

    def get_str(self, key: str, index: int = 0, default: str = "") -> str:
        b = self.get_bytes(key, index, default.encode("utf-8"))
        return b.decode("utf-8", errors="replace")

    def set_bytes(self, key: str, *values: bytes) -> "Example":
        self.features[key] = [
            v.encode("utf-8") if isinstance(v, str) else bytes(v) for v in values
        ]
        return self

    def set_floats(self, key: str, *values: float) -> "Example":
        self.features[key] = [float(v) for v in values]
        return self

    def set_ints(self, key: str, *values: int) -> "Example":
        self.features[key] = [int(v) for v in values]
        return self

    # -- wire format --
    def serialize(self) -> bytes:
        feats = bytearray()
        for key in self.features:  # insertion order; fine for a map field
            entry = bytearray()
            _write_len_delimited(entry, 1, key.encode("utf-8"))
            _write_len_delimited(entry, 2, _encode_feature(self.features[key]))
            _write_len_delimited(feats, 1, bytes(entry))
        out = bytearray()
        _write_len_delimited(out, 1, bytes(feats))
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes) -> "Example":
        ex = cls()
        for field, wire, val in _iter_fields(data):
            if field == 1 and wire == _WIRE_LEN:  # Features
                for f2, w2, entry in _iter_fields(val):  # map entries
                    if f2 != 1 or w2 != _WIRE_LEN:
                        continue
                    key: str = ""
                    feature_body: bytes = b""
                    for f3, w3, v3 in _iter_fields(entry):
                        if f3 == 1:
                            key = v3.decode("utf-8")  # type: ignore[union-attr]
                        elif f3 == 2:
                            feature_body = v3  # type: ignore[assignment]
                    kind_values: FeatureValue = []
                    for f4, w4, v4 in _iter_fields(feature_body):
                        if f4 == 1:
                            kind_values = _decode_scalar_list(v4, "bytes")
                        elif f4 == 2:
                            kind_values = _decode_scalar_list(v4, "float")
                        elif f4 == 3:
                            kind_values = _decode_scalar_list(v4, "int64")
                    ex.features[key] = kind_values
        return ex

    # Mutable (set_* mutate in place), hence deliberately unhashable;
    # dedup on ex.serialize() bytes instead.
    __hash__ = None  # type: ignore[assignment]

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Example) and self.features == other.features

    def __repr__(self) -> str:
        return f"Example({self.features!r})"
