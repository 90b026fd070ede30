"""Minimal WAV reader (stdlib + NumPy; no soundfile/audioread dependency);
the port's copy of ``mint_tpu/audio/wav.py``.

Supports PCM 8/16/24/32-bit and IEEE float WAVs, with mono mixdown matching
``librosa.load(..., mono=True)`` semantics (mean over channels of the
float-converted signal).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1], sample_rate).

    Returns shape [T] if mono else [T, channels].
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # SubFormat GUID's first 2 bytes hold the real format tag.
                real = struct.unpack_from("<H", body, 24)[0]
                fmt = (real,) + fmt[1:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, channels, rate, _, _, bits = fmt

    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    elif tag == _WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            val = (b[:, 0].astype(np.int32)
                   | (b[:, 1].astype(np.int32) << 8)
                   | (b[:, 2].astype(np.int32) << 16))
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {tag:#x}")

    if channels > 1:
        x = x[:len(x) - len(x) % channels].reshape(-1, channels)
        if mono:
            x = x.mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), rate
