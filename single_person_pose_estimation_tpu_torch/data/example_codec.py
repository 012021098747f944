"""Minimal tf.train.Example protobuf codec — no TensorFlow dependency.

The reference stores its dataset as TFRecord shards of tf.train.Example
protos with a 14-feature schema (gen_tfrecords.py:71-86). To interoperate
with shards produced by the reference (and to keep the ETL dependency-free),
this module hand-implements the tiny subset of protobuf wire format those
protos use:

  Example      { Features features = 1; }
  Features     { map<string, Feature> feature = 1; }   // repeated entry
  Feature      { oneof { BytesList bytes_list = 1;
                         FloatList float_list = 2;
                         Int64List int64_list = 3; } }
  BytesList    { repeated bytes value = 1; }
  FloatList    { repeated float value = 1 [packed]; }
  Int64List    { repeated int64 value = 1 [packed]; }

Wire format: tag = (field_number << 3) | wire_type; wire types used:
0 = varint, 2 = length-delimited, 5 = fixed32. Packed and unpacked repeated
scalars are both accepted on decode (TF emits packed).

The port's copy of the JAX package's `data/example_codec.py` (pure
Python, unchanged); `tests/test_torch_records.py` holds the two byte for
byte.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

FeatureValue = Union[List[bytes], List[float], List[int]]

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_LEN = 2
_WIRE_FIXED32 = 5


# ---------------------------------------------------------------------------
# varint + tag primitives
# ---------------------------------------------------------------------------

def _write_varint(buf: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64  # two's complement for negative int64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _write_tag(buf: bytearray, field: int, wire: int) -> None:
    _write_varint(buf, (field << 3) | wire)


def _write_len_delimited(buf: bytearray, field: int, payload: bytes) -> None:
    _write_tag(buf, field, _WIRE_LEN)
    _write_varint(buf, len(payload))
    buf += payload


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def _encode_feature(value: FeatureValue) -> bytes:
    inner = bytearray()
    if not value:
        # Empty list: emit an empty Int64List (TF writes typed empty lists;
        # the type of an empty list is unobservable on parse).
        _write_len_delimited(inner, 3, b"")
        return bytes(inner)
    first = value[0]
    lst = bytearray()
    if isinstance(first, (bytes, bytearray, str)):
        for v in value:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _write_len_delimited(lst, 1, bytes(v))
        _write_len_delimited(inner, 1, bytes(lst))          # bytes_list = 1
    elif isinstance(first, float):
        packed = struct.pack(f"<{len(value)}f", *value)
        _write_len_delimited(lst, 1, packed)
        _write_len_delimited(inner, 2, bytes(lst))          # float_list = 2
    elif isinstance(first, (int,)):
        for v in value:
            _write_varint(lst, int(v))
        packed = bytearray()
        _write_len_delimited(packed, 1, bytes(lst))
        _write_len_delimited(inner, 3, bytes(packed))       # int64_list = 3
    else:
        raise TypeError(f"unsupported feature element type {type(first)}")
    return bytes(inner)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize {name: list-of-bytes|float|int} to a tf.train.Example.

    Entries are written in sorted key order (deterministic output; protobuf
    map order is semantically irrelevant).
    """
    feats = bytearray()
    for key in sorted(features):
        entry = bytearray()
        _write_len_delimited(entry, 1, key.encode("utf-8"))      # key
        _write_len_delimited(entry, 2, _encode_feature(features[key]))
        _write_len_delimited(feats, 1, bytes(entry))             # map entry
    out = bytearray()
    _write_len_delimited(out, 1, bytes(feats))                   # features = 1
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

def _skip_field(data: bytes, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(data, pos)
    elif wire == _WIRE_FIXED64:
        pos += 8
    elif wire == _WIRE_LEN:
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire == _WIRE_FIXED32:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _decode_scalar_list(data: bytes, unpack_fixed: str, fixed_size: int,
                        signed: bool):
    """Parse {repeated scalar value = 1} supporting packed and unpacked."""
    out: list = []
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1:
            pos = _skip_field(data, pos, wire)
            continue
        if wire == _WIRE_LEN:  # packed
            n, pos = _read_varint(data, pos)
            if unpack_fixed:
                count = n // fixed_size
                out.extend(struct.unpack_from(f"<{count}{unpack_fixed}", data, pos))
                pos += n
            else:
                stop = pos + n
                while pos < stop:
                    v, pos = _read_varint(data, pos)
                    if signed and v >= 1 << 63:
                        v -= 1 << 64
                    out.append(v)
        elif wire == _WIRE_FIXED32:
            out.append(struct.unpack_from("<f", data, pos)[0])
            pos += 4
        elif wire == _WIRE_VARINT:
            v, pos = _read_varint(data, pos)
            if signed and v >= 1 << 63:
                v -= 1 << 64
            out.append(v)
        else:
            pos = _skip_field(data, pos, wire)
    return out


def _decode_bytes_list(data: bytes) -> List[bytes]:
    out = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == _WIRE_LEN:
            n, pos = _read_varint(data, pos)
            out.append(data[pos:pos + n])
            pos += n
        else:
            pos = _skip_field(data, pos, wire)
    return out


def _decode_feature(data: bytes) -> FeatureValue:
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire != _WIRE_LEN:
            pos = _skip_field(data, pos, wire)
            continue
        n, pos = _read_varint(data, pos)
        payload = data[pos:pos + n]
        pos += n
        if field == 1:
            return _decode_bytes_list(payload)
        if field == 2:
            return _decode_scalar_list(payload, "f", 4, signed=False)
        if field == 3:
            return _decode_scalar_list(payload, "", 0, signed=True)
    return []


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
    """Parse a serialized tf.train.Example into {name: list}."""
    features: Dict[str, FeatureValue] = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1 or wire != _WIRE_LEN:
            pos = _skip_field(data, pos, wire)
            continue
        n, pos = _read_varint(data, pos)
        feats = data[pos:pos + n]
        pos += n
        fpos = 0
        while fpos < len(feats):
            ftag, fpos = _read_varint(feats, fpos)
            ffield, fwire = ftag >> 3, ftag & 7
            if ffield != 1 or fwire != _WIRE_LEN:
                fpos = _skip_field(feats, fpos, fwire)
                continue
            en, fpos = _read_varint(feats, fpos)
            entry = feats[fpos:fpos + en]
            fpos += en
            key = None
            value: FeatureValue = []
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                efield, ewire = etag >> 3, etag & 7
                if ewire != _WIRE_LEN:
                    epos = _skip_field(entry, epos, ewire)
                    continue
                vn, epos = _read_varint(entry, epos)
                payload = entry[epos:epos + vn]
                epos += vn
                if efield == 1:
                    key = payload.decode("utf-8")
                elif efield == 2:
                    value = _decode_feature(payload)
            if key is not None:
                features[key] = value
    return features
