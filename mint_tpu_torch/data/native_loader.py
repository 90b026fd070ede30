"""ctypes bindings for the port's C++ training data loader (counterpart of
``mint_tpu/data/native_loader.py``).

The hot training input path (TFRecord framing with both CRC32C checks,
Example wire parsing, FACT windowing, the shuffle buffer and the
decoded-record cache) runs in a C++ reader thread
(``mint_tpu_torch/csrc/mint_loader.cc``, the port's own copy of the JAX
package's loader), so Python never touches a record's bytes; each
``next()`` fills three NumPy batch buffers by memcpy, with the
interpreter lock released.  With the same shards, seed and cache budget
it yields the JAX package's loader's batches bit for bit.

The library is built with ``g++`` at first use, never at import, into
``mint_tpu_torch/_build/``, named by a hash of the source and the flags
(an unchanged tree reuses it).  Concurrent first uses (the test workers,
the ranks of one host) build under an inter-process ``fcntl`` lock into
a temporary file that is renamed into place, so no process loads a torn
library.  :func:`available` says whether the build succeeded and
:func:`build_error` why not; the train CLI's ``--input_backend=auto``
then takes the Python pipeline (:mod:`mint_tpu_torch.data.pipeline`),
and ``native`` raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "mint_loader.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> str:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmint_loader_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    """Build `out` unless another process has: under the build lock, into
    a temporary file renamed into place."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++ or c++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".mint_loader.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):  # built while this process waited
                return
            tmp = f"{out}.tmp.{os.getpid()}"
            try:
                subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            out = library_path()
            if not os.path.exists(out):
                _compile(out)
            lib = ctypes.CDLL(out)
        except subprocess.CalledProcessError as e:
            _build_error = f"g++ failed:\n{e.stderr}"
            return None
        except OSError as e:
            _build_error = str(e)
            return None
        lib.mint_loader_open.restype = ctypes.c_void_p
        lib.mint_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_uint64]
        lib.mint_loader_next.restype = ctypes.c_int
        lib.mint_loader_next.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_float)] * 3
        lib.mint_loader_close.restype = None
        lib.mint_loader_close.argtypes = [ctypes.c_void_p]
        lib.mint_masked_crc32c.restype = ctypes.c_uint32
        lib.mint_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    _load()
    return _build_error


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC32C of `data`, computed by the library."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    return int(lib.mint_masked_crc32c(data, len(data)))


class NativeTrainLoader:
    """Endless shuffled training batches from tfrecord shards.

    Yields dict batches of the Python pipeline's training contract, f32
    NumPy arrays: ``motion_input`` [B, motion_len, motion_dim_raw + 6],
    ``target`` [B, target_len, motion_dim_raw + 6], ``audio_input``
    [B, audio_len, audio_dim].  `cache_bytes` is the decoded-record
    cache's budget (default: ``MINT_TPU_LOADER_CACHE_MB``, else 4096 MB;
    0 streams every epoch; a corpus that outgrows it streams from then
    on).  Raises StopIteration once no shard yields a usable window.
    """

    def __init__(self, files: Sequence[str], batch_size: int,
                 motion_input_len: int, target_len: int, target_shift: int,
                 audio_input_len: int, motion_dim_raw: int = 219,
                 audio_dim: int = 35, shuffle_buffer: int = 100,
                 seed: int = 0, cache_bytes: Optional[int] = None):
        if batch_size < 1 or shuffle_buffer < 1:
            # shuffle_buffer=0 deadlocks the C++ reader (its buffer never
            # has room) and batch_size=0 ends the data at once.
            raise ValueError(
                f"batch_size ({batch_size}) and shuffle_buffer "
                f"({shuffle_buffer}) must both be >= 1")
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        if cache_bytes is None:
            cache_bytes = int(os.environ.get(
                "MINT_TPU_LOADER_CACHE_MB", "4096")) << 20
        mdim = motion_dim_raw + 6
        self._shapes = ((batch_size, motion_input_len, mdim),
                        (batch_size, target_len, mdim),
                        (batch_size, audio_input_len, audio_dim))
        names = (ctypes.c_char_p * len(files))(
            *[os.fsencode(f) for f in files])
        self._handle = lib.mint_loader_open(
            names, len(files), batch_size, motion_input_len, target_len,
            target_shift, audio_input_len, motion_dim_raw, audio_dim,
            shuffle_buffer, seed, cache_bytes)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._handle is None:
            raise StopIteration
        motion, target, audio = (np.empty(s, np.float32)
                                 for s in self._shapes)
        ptr = ctypes.POINTER(ctypes.c_float)
        n = self._lib.mint_loader_next(
            self._handle, motion.ctypes.data_as(ptr),
            audio.ctypes.data_as(ptr), target.ctypes.data_as(ptr))
        if n == 0:
            raise StopIteration
        return {"motion_input": motion, "target": target,
                "audio_input": audio}

    def close(self) -> None:
        """Stop the reader thread and free the loader (idempotent)."""
        if self._handle is not None:
            self._lib.mint_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
