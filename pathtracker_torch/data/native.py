"""ctypes binding of the C++ TFRecord reader, ``native/ptdata.cc``
(pathtracker_tpu/data/native.py).

The library inflates a GZIP shard, walks the record framing and pulls each
tf.train.Example's clip and label byte into one contiguous buffer, with the
GIL released, so the pipeline's decode thread overlaps the device work. It
also computes CRC32C for the writer.

The port builds the library itself at first use, with the flags of
``native/Makefile``, into ``build/libptdata_<hash>.so``; the hash covers the
source and the flags, so an edited source builds anew. Several processes
may build at once: each writes its own temporary file and renames it into
place. Nothing builds at import. Where the build fails (no ``g++``, no
``zlib.h``), ``available()`` is False and ``data/tfrecord.py``'s Python codec
reads and writes the shards instead, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "ptdata.cc"
BUILD = ROOT / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LD_FLAGS = ("-lz",)

_LIB = None
_TRIED = False
_LOCK = threading.Lock()  # the first use may come from a loader's thread


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return BUILD / f"libptdata_{digest.hexdigest()[:16]}.so"


def build() -> Path | None:
    """Compile ``native/ptdata.cc`` unless it is built; the library's path,
    or None (with a warning) where it cannot be built."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        warnings.warn("g++ not found: the TFRecord shards are read by the "
                      "pure-Python codec", stacklevel=2)
        return None
    BUILD.mkdir(exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LD_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        warnings.warn(f"native/ptdata.cc did not build, so the TFRecord shards "
                      f"are read by the pure-Python codec:\n{proc.stderr[-2000:]}",
                      stacklevel=2)
        return None
    os.replace(tmp, path)
    return path


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _bind(build())
            _TRIED = True
    return _LIB


def _bind(path):
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.ptdata_read_file.restype = ctypes.c_void_p
    lib.ptdata_read_file.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ptdata_num_records.restype = ctypes.c_long
    lib.ptdata_num_records.argtypes = [ctypes.c_void_p]
    lib.ptdata_clips_ptr.restype = ctypes.c_void_p
    lib.ptdata_clips_ptr.argtypes = [ctypes.c_void_p]
    lib.ptdata_labels_ptr.restype = ctypes.c_void_p
    lib.ptdata_labels_ptr.argtypes = [ctypes.c_void_p]
    lib.ptdata_free.restype = None
    lib.ptdata_free.argtypes = [ctypes.c_void_p]
    lib.ptdata_crc32c.restype = ctypes.c_uint
    lib.ptdata_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_long]
    return lib


def available() -> bool:
    """Whether the native library is built (building it on the first call)."""
    return _load() is not None


def crc32c(data: bytes):
    """CRC32C via the native library, or None where it is not available."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.ptdata_crc32c(data, len(data)))


class ShardView:
    """Zero-copy view over one decoded shard (clips [N,T,H,W,3], labels [N]).

    The buffer belongs to the library's handle, and ``close()`` hands the
    handle back to a pool that the next shard's decode reuses: use the views
    only while the ShardView is open, and copy whatever outlives it (numpy
    fancy indexing copies, so gathered batches are safe)."""

    def __init__(self, path: str, timesteps: int, height: int = 32,
                 width: int = 32):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native TFRecord reader is not available")
        self._lib = lib
        self._handle = lib.ptdata_read_file(os.fsencode(path),
                                            timesteps * height * width * 3)
        if not self._handle:
            raise IOError(f"ptdata failed to read {path}")
        n = lib.ptdata_num_records(self._handle)
        if n == 0:  # an empty shard: its data pointers may be NULL
            self.clips = np.empty((0, timesteps, height, width, 3), np.uint8)
            self.labels = np.empty((0,), np.uint8)
            return
        cptr = lib.ptdata_clips_ptr(self._handle)
        lptr = lib.ptdata_labels_ptr(self._handle)
        self.clips = np.ctypeslib.as_array(
            ctypes.cast(cptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(n, timesteps, height, width, 3))
        self.labels = np.ctypeslib.as_array(
            ctypes.cast(lptr, ctypes.POINTER(ctypes.c_uint8)), shape=(n,))

    def __len__(self) -> int:
        return int(self.labels.shape[0])

    def close(self):
        if self._handle:
            self._lib.ptdata_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_clip_records(path: str, timesteps: int, height: int = 32, width: int = 32):
    """Yield (uint8 [T,H,W,3] clip, label byte) from one shard, each clip a
    copy (the pipeline's batch gather reads ShardView directly)."""
    with ShardView(path, timesteps, height, width) as shard:
        for i in range(len(shard)):
            yield shard.clips[i].copy(), int(shard.labels[i])
