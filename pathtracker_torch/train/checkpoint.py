"""Checkpoint IO and best-checkpoint selection
(pathtracker_tpu/train/checkpoint.py).

One format for both packages: ``{"state_dict": params, "epoch", "acc",
"extra"}`` serialized as flax's msgpack, the params in the JAX package's
names and layouts — a flat {name: array} dict for the InT family and a
nested tree for ``rntsm`` (``stem/kernel``, ``layer1_0/conv1/bn_scale``,
..., ``fc1_kernel``). A checkpoint written here is a JAX-package checkpoint
and the reverse. Neither flax nor msgpack is a dependency of the port, so
this module carries a msgpack writer and reader for exactly the types flax
writes: maps, arrays, str, bin, ints, floats, nil, bool, ext type 1 — an
ndarray, itself a msgpack ``(shape, dtype name, C-order bytes)``
(flax.serialization._ndarray_to_bytes) — and, read only, ext type 3, a
numpy scalar packed the same way. The writer's bytes equal
``flax.serialization.msgpack_serialize``'s for the same tree.

The reference's own checkpoints are torch pickles (zip or legacy); they are
read with ``torch.load(weights_only=True)`` and mapped onto the params by
layout (train/torch_import.py). ``find_best_checkpoint`` reproduces the
val.npz-argmax, mtime-sorted selection of reference test_model.py:59-64.
"""

from __future__ import annotations

import glob
import os
import pickle
import struct

import numpy as np
import torch

from pathtracker_torch.train import torch_import

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
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
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not supported")
    shape, dtype_name, buffer = unpackb(data)
    arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)
    return arr if code == _EXT_NDARRAY else arr[()]


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


def _pack_length(out: bytearray, n: int, small: int | None, fix_max: int,
                 tags: tuple) -> None:
    """A length header: the fix form where ``n`` fits it, else the smallest
    of the 8/16/32-bit forms (``tags``; None where the kind has no 8-bit
    form), as the msgpack package picks."""
    if small is not None and n <= fix_max:
        out.append(small | n)
        return
    for tag, fmt in zip(tags, (">B", ">H", ">I")):
        if tag is not None and n <= (1 << (8 * struct.calcsize(fmt))) - 1:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


_INT_FORMS = ((0, 0xff, 0xcc, ">B"), (-0x80, -1, 0xd0, ">b"),
              (0, 0xffff, 0xcd, ">H"), (-0x8000, -1, 0xd1, ">h"),
              (0, 0xffffffff, 0xce, ">I"), (-0x80000000, -1, 0xd2, ">i"),
              (0, 0xffffffffffffffff, 0xcf, ">Q"),
              (-0x8000000000000000, -1, 0xd3, ">q"))


def _pack(obj, out: bytearray) -> None:
    kind = type(obj)  # exact types, as flax's strict_types packer
    if obj is None:
        out.append(0xc0)
    elif kind is bool:
        out.append(0xc3 if obj else 0xc2)
    elif kind is int:
        if -0x20 <= obj < 0x80:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
            return
        for lo, hi, tag, fmt in _INT_FORMS:
            if lo <= obj <= hi:
                out.append(tag)
                out += struct.pack(fmt, obj)
                return
        raise OverflowError(f"integer {obj} does not fit msgpack")
    elif kind is float:
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif kind is str:
        raw = obj.encode("utf-8")
        _pack_length(out, len(raw), 0xa0, 0x1f, (0xd9, 0xda, 0xdb))
        out += raw
    elif kind is bytes:
        _pack_length(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif kind in (list, tuple):
        _pack_length(out, len(obj), 0x90, 0x0f, (None, 0xdc, 0xdd))
        for item in obj:
            _pack(item, out)
    elif kind is dict:
        # flax rebuilds the tree with jax.tree_util before packing, which
        # orders every dict by its sorted keys.
        _pack_length(out, len(obj), 0x80, 0x0f, (None, 0xde, 0xdf))
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serializable")
        data = packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(len(data))
        if fixext is None:
            _pack_length(out, len(data), None, 0, (0xc7, 0xc8, 0xc9))
        else:
            out.append(fixext)
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        out += struct.pack(">b", code)
        out += data
    else:
        raise TypeError(f"cannot serialize {kind.__name__} to a checkpoint")


def packb(obj) -> bytes:
    """Encode ``obj`` (dicts, lists, str, bytes, ints, floats, None, bool,
    numpy arrays and scalars) as ``flax.serialization.msgpack_serialize``
    does."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def save_checkpoint(path: str, state_dict: dict, epoch: int = 0, acc: float = 0.0,
                    extra: dict | None = None) -> None:
    """Write ``state_dict`` (the port's, or tensors keyed like it) in the
    JAX package's names and layouts, with ``epoch`` and ``acc`` as 0-d
    arrays, as pathtracker_tpu.train.checkpoint.save_checkpoint does; the
    file is written beside ``path`` and renamed into place."""
    blob = packb({"state_dict": torch_import.to_jax_params(state_dict),
                  "epoch": np.asarray(epoch), "acc": np.asarray(acc),
                  "extra": extra or {}})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def _is_torch_pickle(path: str) -> bool:
    """A zip archive or a bare pickle stream (PROTO 0x80 + protocol 2-5; a
    lone 0x80 is msgpack's empty map)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:4] == b"PK\x03\x04":
        return True
    return len(head) >= 2 and head[0] == 0x80 and 2 <= head[1] <= 5


def load_checkpoint(path: str) -> dict:
    """The whole checkpoint: nested dicts/lists with numpy array leaves for
    a msgpack file; for a torch pickle, what it holds (a state_dict or a
    ``{'state_dict': ...}`` wrapper) with CPU tensors. A pickle is read with
    ``weights_only=True`` only; one that it refuses raises."""
    if _is_torch_pickle(path):
        try:
            return torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise pickle.UnpicklingError(
                f"{path}: torch.load(weights_only=True) refused the pickle: {e}") from e
    with open(path, "rb") as f:
        return unpackb(f.read())


def load_params(path: str, template=None, strict: bool = True):
    """The params of a checkpoint in the JAX names and layouts: a flat dict
    (InT family) or a nested one (``rntsm``, the video ResNets, SlowFast,
    the transformers, stlstm's cell); turn them into the port's
    state_dict with ``train.torch_import.state_dict_from_jax``.

    ``template`` is a params tree in the same names and layouts (e.g.
    ``to_jax_params(model.state_dict())``), or a function that returns one,
    called only when the template is read. With it, ``strict=False`` keeps
    the template's values where the checkpoint lacks a parameter. A
    reference torch checkpoint (a raw state_dict or ``{'state_dict': ...}``,
    with or without DataParallel's ``module.`` prefix) needs the template:
    it is routed by layout and imported onto it (train/torch_import.py)."""
    state = load_checkpoint(path)
    params = state["state_dict"] if "state_dict" in state else state
    if torch_import.looks_like_torch_state_dict(params):
        if template is None:
            raise ValueError(
                "a reference torch checkpoint needs a parameter template to "
                "import into; load it through engine.load_ckpt")
        template = template() if callable(template) else template
        if torch_import.looks_like_tsm_resnet_state_dict(params):
            # resnet_TSM (rntsm) or a plain torchvision ImageNet ResNet
            return torch_import.import_tsm_resnet_state_dict(
                params, template, strict=strict)
        if torch_import.looks_like_video_resnet_state_dict(params):
            # torchvision's r3d/mc3/r2plus1 or the reference's forks of them
            return torch_import.import_video_resnet_state_dict(
                params, template, strict=strict)
        if torch_import.looks_like_slowfast_state_dict(params):
            # FAIR pyslowfast layout (the reference's slowfast / slowfast_nl)
            return torch_import.import_slowfast_state_dict(
                params, template, strict=strict)
        return torch_import.import_reference_state_dict(params, template,
                                                        strict=strict)
    if template is None or strict:
        return params
    return _merge(template() if callable(template) else template, params)


def _merge(template, loaded):
    if isinstance(template, dict) and isinstance(loaded, dict):
        return {k: _merge(template[k], loaded[k]) if k in loaded else template[k]
                for k in template}
    return loaded if loaded is not None else template


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
