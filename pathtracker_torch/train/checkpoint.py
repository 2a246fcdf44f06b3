"""Checkpoint reading and best-checkpoint selection
(pathtracker_tpu/train/checkpoint.py:50-125).

The JAX package writes ``{"state_dict": params, "epoch", "acc", "extra"}``
with flax's msgpack serialization; the params are a flat {name: array} dict
for the InT family and a nested flax tree for ``rntsm`` (``stem/kernel``,
``layer1_0/conv1/bn_scale``, ..., ``fc1_kernel``). Neither flax nor msgpack is a
dependency of the port, so this module carries a small msgpack reader for
exactly the types flax writes: maps, arrays, str, bin, ints, floats, nil,
bool, and ext type 1 — an ndarray, itself a msgpack ``(shape, dtype name,
C-order bytes)`` (flax.serialization._ndarray_to_bytes). Saving, and reading
the reference's torch-pickle checkpoints, come with the training slice.
``find_best_checkpoint`` reproduces the val.npz-argmax, mtime-sorted
selection of reference test_model.py:59-64.
"""

from __future__ import annotations

import glob
import os
import struct

import numpy as np

_EXT_NDARRAY = 1
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _take(buf, pos, n):
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")
    return buf[pos:pos + n], pos + n


def _length(buf, pos, width):
    raw, pos = _take(buf, pos, width)
    return struct.unpack(_LEN[width], raw)[0], pos


def _ext(code, data):
    if code != _EXT_NDARRAY:
        raise ValueError(f"msgpack ext type {code} is not supported")
    shape, dtype_name, buffer = unpackb(data)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _unpack(buf, pos):
    tag, pos = buf[pos], pos + 1
    if tag <= 0x7f:
        return tag, pos
    if tag >= 0xe0:
        return tag - 0x100, pos
    if tag <= 0x8f or tag in _MAP:
        if tag <= 0x8f:
            n = tag & 0x0f
        else:
            n, pos = _length(buf, pos, _MAP[tag])
        out = {}
        for _ in range(n):
            key, pos = _unpack(buf, pos)
            out[key], pos = _unpack(buf, pos)
        return out, pos
    if tag <= 0x9f or tag in _ARRAY:
        if tag <= 0x9f:
            n = tag & 0x0f
        else:
            n, pos = _length(buf, pos, _ARRAY[tag])
        out = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            out.append(item)
        return out, pos
    if tag <= 0xbf or tag in _STR:
        if tag <= 0xbf:
            n = tag & 0x1f
        else:
            n, pos = _length(buf, pos, _STR[tag])
        raw, pos = _take(buf, pos, n)
        return str(raw, "utf-8"), pos
    if tag == 0xc0:
        return None, pos
    if tag in (0xc2, 0xc3):
        return tag == 0xc3, pos
    if tag in _FIXED:
        fmt = _FIXED[tag]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], pos
    if tag in _BIN:
        n, pos = _length(buf, pos, _BIN[tag])
        raw, pos = _take(buf, pos, n)
        return bytes(raw), pos
    if tag in _EXT or tag in _FIXEXT:
        if tag in _EXT:
            n, pos = _length(buf, pos, _EXT[tag])
        else:
            n = _FIXEXT[tag]
        raw, pos = _take(buf, pos, 1)
        code = struct.unpack(">b", raw)[0]
        data, pos = _take(buf, pos, n)
        return _ext(code, bytes(data)), pos
    raise ValueError(f"msgpack type byte 0x{tag:02x} is not supported")


def unpackb(data: bytes):
    """Decode one msgpack object (flax's types) from ``data``."""
    buf = memoryview(data)
    value, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes after the msgpack object")
    return value


def _is_torch_pickle(path: str) -> bool:
    """A zip archive or a bare pickle stream (PROTO 0x80 + protocol 2-5; a
    lone 0x80 is msgpack's empty map)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:4] == b"PK\x03\x04":
        return True
    return len(head) >= 2 and head[0] == 0x80 and 2 <= head[1] <= 5


def load_checkpoint(path: str) -> dict:
    """The whole checkpoint as nested dicts/lists with numpy array leaves."""
    if _is_torch_pickle(path):
        raise NotImplementedError(
            f"{path} is a torch pickle: reading the reference's torch "
            "checkpoints comes with the training slice of pathtracker_torch")
    with open(path, "rb") as f:
        return unpackb(f.read())


def load_params(path: str) -> dict:
    """The params of a checkpoint in the JAX names and layouts: a flat dict
    (InT family) or a nested one (``rntsm``). Turn them into the port's
    state_dict with ``train.torch_import.state_dict_from_jax``."""
    state = load_checkpoint(path)
    return state["state_dict"] if "state_dict" in state else state


def find_best_checkpoint(results_folder: str) -> str:
    """The val.npz balacc argmax, indexed into the mtime-sorted
    saved_models/*.tar (reference test_model.py:59-64)."""
    perfs = np.load(os.path.join(results_folder, "val.npz"))["balacc"]
    arg_perf = int(np.argmax(perfs))
    weights = glob.glob(os.path.join(results_folder, "saved_models", "*.tar"))
    # The rolling last-epoch snapshot is not a best-val checkpoint; it is
    # always the newest file, so the clamp below would otherwise pick it.
    weights = [w for w in weights
               if os.path.basename(w) != "model_last_epoch_checkpoint.pth.tar"]
    weights.sort(key=os.path.getmtime)
    if not weights:
        raise FileNotFoundError(f"no checkpoints under {results_folder}/saved_models")
    # Checkpoints exist only for improving epochs while val.npz has one
    # entry per epoch, so the index is clamped, as the reference's was.
    return weights[min(arg_perf, len(weights) - 1)]
