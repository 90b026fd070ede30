"""`tf.train.Example` wire-format codec (no protobuf dependency): the port's
copy of ``mint_tpu/data/example.py``.

The reference serializes one AIST++ sequence per Example with features
``motion_sequence`` / ``motion_sequence_shape`` / ``motion_name`` and the
audio equivalents (tools/preprocessing.py:54-69).  This module encodes and
decodes exactly that proto wire format by hand.

Message schema (field numbers from tensorflow/core/example/):

    Example   { Features features = 1; }
    Features  { map<string, Feature> feature = 1; }
    Feature   { oneof { BytesList bytes_list = 1;
                        FloatList float_list = 2;
                        Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed]; }
    Int64List { repeated int64 value = 1 [packed]; }
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

FeatureValue = Union[List[bytes], np.ndarray]


# --- varint helpers ---------------------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


# --- encoding ---------------------------------------------------------------


def _encode_bytes_list(values: List[bytes]) -> bytes:
    out = bytearray()
    for v in values:
        _write_varint(out, _tag(1, 2))
        _write_varint(out, len(v))
        out += v
    return bytes(out)


def _encode_float_list(values: np.ndarray) -> bytes:
    data = np.asarray(values, dtype="<f4").tobytes()
    out = bytearray()
    _write_varint(out, _tag(1, 2))
    _write_varint(out, len(data))
    out += data
    return bytes(out)


def _encode_int64_list(values: np.ndarray) -> bytes:
    payload = bytearray()
    for v in np.asarray(values, dtype=np.int64).ravel():
        _write_varint(payload, int(v) & 0xFFFFFFFFFFFFFFFF)
    out = bytearray()
    _write_varint(out, _tag(1, 2))
    _write_varint(out, len(payload))
    out += payload
    return bytes(out)


def _encode_feature(value: FeatureValue) -> bytes:
    if isinstance(value, (list, tuple)) and (
            not value or isinstance(value[0], (bytes, str))):
        vals = [v.encode("utf-8") if isinstance(v, str) else v for v in value]
        body = _encode_bytes_list(vals)
        field = 1
    else:
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.integer):
            body = _encode_int64_list(arr)
            field = 3
        else:
            body = _encode_float_list(arr)
            field = 2
    out = bytearray()
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(body))
    out += body
    return bytes(out)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Encode a dict of features to tf.train.Example bytes.

    Values: list of bytes/str -> BytesList; integer ndarray -> Int64List;
    float ndarray -> FloatList (flattened).
    """
    feats = bytearray()
    for name, value in features.items():
        key = name.encode("utf-8")
        entry = bytearray()
        _write_varint(entry, _tag(1, 2))
        _write_varint(entry, len(key))
        entry += key
        fbody = _encode_feature(value)
        _write_varint(entry, _tag(2, 2))
        _write_varint(entry, len(fbody))
        entry += fbody
        _write_varint(feats, _tag(1, 2))
        _write_varint(feats, len(entry))
        feats += entry
    out = bytearray()
    _write_varint(out, _tag(1, 2))
    _write_varint(out, len(feats))
    out += feats
    return bytes(out)


# --- decoding ---------------------------------------------------------------


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        size, pos = _read_varint(buf, pos)
        pos += size
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _decode_value_list(buf: bytes, field: int):
    """Decode BytesList/FloatList/Int64List body."""
    pos = 0
    end = len(buf)
    if field == 1:
        values: List[bytes] = []
        while pos < end:
            tag, pos = _read_varint(buf, pos)
            if tag == _tag(1, 2):
                size, pos = _read_varint(buf, pos)
                values.append(buf[pos:pos + size])
                pos += size
            else:
                pos = _skip_field(buf, pos, tag & 7)
        return values
    if field == 2:
        chunks = []
        while pos < end:
            tag, pos = _read_varint(buf, pos)
            if tag == _tag(1, 2):  # packed
                size, pos = _read_varint(buf, pos)
                chunks.append(np.frombuffer(buf, dtype="<f4", count=size // 4,
                                            offset=pos))
                pos += size
            elif tag == _tag(1, 5):  # unpacked single float
                chunks.append(np.frombuffer(buf, dtype="<f4", count=1,
                                            offset=pos))
                pos += 4
            else:
                pos = _skip_field(buf, pos, tag & 7)
        return (np.concatenate(chunks) if chunks
                else np.zeros((0,), np.float32))
    if field == 3:
        values = []
        while pos < end:
            tag, pos = _read_varint(buf, pos)
            if tag == _tag(1, 2):  # packed
                size, pos = _read_varint(buf, pos)
                stop = pos + size
                while pos < stop:
                    v, pos = _read_varint(buf, pos)
                    values.append(v - (1 << 64) if v >= (1 << 63) else v)
            elif tag == _tag(1, 0):
                v, pos = _read_varint(buf, pos)
                values.append(v - (1 << 64) if v >= (1 << 63) else v)
            else:
                pos = _skip_field(buf, pos, tag & 7)
        return np.asarray(values, dtype=np.int64)
    raise ValueError(f"unknown feature field {field}")


def _decode_feature(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2 and field in (1, 2, 3):
            size, pos = _read_varint(buf, pos)
            return _decode_value_list(buf[pos:pos + size], field)
        pos = _skip_field(buf, pos, wire)
    return None


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
    """Decode tf.train.Example bytes into {name: value}."""
    features: Dict[str, FeatureValue] = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        if tag == _tag(1, 2):  # Example.features
            size, pos = _read_varint(data, pos)
            fbuf = data[pos:pos + size]
            pos += size
            fpos = 0
            while fpos < len(fbuf):
                ftag, fpos = _read_varint(fbuf, fpos)
                if ftag == _tag(1, 2):  # Features.feature map entry
                    esize, fpos = _read_varint(fbuf, fpos)
                    entry = fbuf[fpos:fpos + esize]
                    fpos += esize
                    name, value = None, None
                    epos = 0
                    while epos < len(entry):
                        etag, epos = _read_varint(entry, epos)
                        if etag == _tag(1, 2):  # key
                            ksize, epos = _read_varint(entry, epos)
                            name = entry[epos:epos + ksize].decode("utf-8")
                            epos += ksize
                        elif etag == _tag(2, 2):  # value (Feature)
                            vsize, epos = _read_varint(entry, epos)
                            value = _decode_feature(entry[epos:epos + vsize])
                            epos += vsize
                        else:
                            epos = _skip_field(entry, epos, etag & 7)
                    if name is not None:
                        features[name] = value
                else:
                    fpos = _skip_field(fbuf, fpos, ftag & 7)
        else:
            pos = _skip_field(data, pos, tag & 7)
    return features
