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

The multi-row document framing of the JAX package's codec is ROADMAP.md
queue 1, item 7.
"""

from __future__ import annotations

from typing import List, Optional

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
