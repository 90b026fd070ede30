"""TFRecord container I/O with no TensorFlow dependency (the port's copy of
``mint_tpu/data/tfrecord.py``):

    uint64 length (LE) | uint32 masked_crc32c(length_bytes) |
    byte data[length]  | uint32 masked_crc32c(data)

CRC is CRC-32C (Castagnoli, reflected, poly 0x1EDC6F41), masked as
``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff``.  As in the JAX
package's copy, :func:`masked_crc32c` takes the port's C++ loader's CRC
(``data/native_loader.py``) where that library builds, probed at the
first call, not at import; where it does not, the pure-Python CRC, whose
byte loop walks a list table, a Python step per byte.
"""

from __future__ import annotations

import glob as globlib
import os
import struct
from typing import Iterator, List, Sequence

_CRC_POLY = 0x82F63B78  # reflected Castagnoli


def _make_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC_POLY if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    """CRC-32C of `data` (reflected, init/final xor 0xffffffff)."""
    crc = 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


_native_masked = None
_native_probed = False


def _native_masked_crc():
    """The C++ masked CRC of the port's native loader, or None where its
    library does not build (probed once, at the first call: the probe may
    run the build)."""
    global _native_masked, _native_probed
    if not _native_probed:
        _native_probed = True
        from mint_tpu_torch.data import native_loader
        if native_loader.available():
            _native_masked = native_loader.masked_crc32c
    return _native_masked


def masked_crc32c(data: bytes) -> int:
    native = _native_masked_crc()
    if native is not None:
        return native(data)
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw records from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != crc:
                    raise IOError(f"{path}: corrupted length crc")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise IOError(f"{path}: truncated record")
            if verify_crc:
                (crc,) = struct.unpack("<I", footer)
                if masked_crc32c(data) != crc:
                    raise IOError(f"{path}: corrupted data crc")
            yield data


def glob(pattern: str) -> List[str]:
    return sorted(globlib.glob(pattern))


def read_many(paths: Sequence[str], verify_crc: bool = False
              ) -> Iterator[bytes]:
    for path in paths:
        yield from read_records(path, verify_crc=verify_crc)
