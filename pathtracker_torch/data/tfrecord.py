"""TF-free TFRecord (GZIP) codec with a minimal tf.train.Example wire parser
(pathtracker_tpu/data/tfrecord.py).

The reference loads clips through tf.data (reference utils/TFRDataset.py:31-53):
GZIP TFRecord files whose records are tf.train.Example protos with features
  {label: bytes, image: bytes(raw uint8), height: int64, width: int64}
(reference utils/TFRDataset.py:7-12). This module speaks the same wire format
in Python; ``data/native.py`` binds the C++ reader (native/ptdata.cc) that
the pipeline uses where it builds.

TFRecord framing (per record):
    uint64 length (LE) | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)

tf.train.Example wire schema (protobuf):
    Example      { 1: Features }
    Features     { 1: repeated FeatureMapEntry }      # map<string, Feature>
    FeatureMapEntry { 1: string key, 2: Feature value }
    Feature      { oneof: 1: BytesList, 2: FloatList, 3: Int64List }
    BytesList    { 1: repeated bytes }
    FloatList    { 1: repeated float (packed) }
    Int64List    { 1: repeated varint (packed or not) }
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from pathtracker_torch.data import native

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven: the TFRecord framing checksums.
# ---------------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78


def _make_crc32c_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_CRC_TABLE = _make_crc32c_table()


def _crc32c_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


_warned_slow_crc = False


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``: the native library's where it builds, the
    table-driven Python one otherwise. The per-record checksums dominate
    TFRecord writing, and the Python one is ~10x slower (a 20,000-clip,
    T=64 dataset takes ~20 minutes instead of ~2), so it warns once, on the
    first large payload."""
    crc = native.crc32c(data)
    if crc is not None:
        return crc
    global _warned_slow_crc
    if not _warned_slow_crc and len(data) > 4096:
        _warned_slow_crc = True
        print("WARNING: native CRC32C not available — TFRecord writes/verifies "
              "run ~10x slower in pure Python. It needs g++ and zlib.h to build "
              "native/ptdata.cc.")
    return _crc32c_py(data)


def masked_crc32c(data: bytes) -> int:
    """TFRecord 'masked' CRC: rotate right by 15 and add a constant."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format primitives.
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value_or_span) over a proto message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_feature(buf: bytes):
    """Parse a Feature proto into a python value list."""
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:  # BytesList
            return [v for f, w, v in _iter_fields(val) if f == 1 and w == 2]
        if field == 2 and wire == 2:  # FloatList
            out = []
            for f, w, v in _iter_fields(val):
                if f == 1 and w == 2:  # packed
                    out.extend(np.frombuffer(v, dtype="<f4").tolist())
                elif f == 1 and w == 5:
                    out.append(struct.unpack("<f", v)[0])
            return out
        if field == 3 and wire == 2:  # Int64List
            out = []
            for f, w, v in _iter_fields(val):
                if f == 1 and w == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        out.append(x - (1 << 64) if x >= (1 << 63) else x)
                elif f == 1 and w == 0:
                    out.append(v - (1 << 64) if v >= (1 << 63) else v)
            return out
    return []


def parse_example(buf: bytes) -> dict:
    """Parse a serialized tf.train.Example into {name: list-of-values}."""
    feats = {}
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:  # Features
            for f, w, entry in _iter_fields(val):
                if f == 1 and w == 2:  # map entry
                    key = None
                    feature = []
                    for ef, ew, ev in _iter_fields(entry):
                        if ef == 1 and ew == 2:
                            key = ev.decode("utf-8")
                        elif ef == 2 and ew == 2:
                            feature = _parse_feature(ev)
                    if key is not None:
                        feats[key] = feature
    return feats


def _tag(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _write_varint(len(payload)) + payload


def build_example(features: dict) -> bytes:
    """Serialize {name: bytes|int|float|list-of-those} as a tf.train.Example."""
    entries = b""
    for key, value in features.items():
        if not isinstance(value, (list, tuple)):
            value = [value]
        if all(isinstance(v, (bytes, bytearray, str)) for v in value):
            items = b"".join(
                _length_delimited(1, v.encode() if isinstance(v, str) else bytes(v))
                for v in value
            )
            feature = _length_delimited(1, items)  # BytesList
        elif all(isinstance(v, (int, np.integer)) for v in value):
            items = b"".join(_tag(1, 0) + _write_varint(int(v) & (1 << 64) - 1) for v in value)
            feature = _length_delimited(3, items)  # Int64List (unpacked)
        else:
            payload = np.asarray(value, dtype="<f4").tobytes()
            feature = _length_delimited(2, _length_delimited(1, payload))  # packed FloatList
        entry = _length_delimited(1, key.encode("utf-8")) + _length_delimited(2, feature)
        entries += _length_delimited(1, entry)
    return _length_delimited(1, entries)  # Example.features


# ---------------------------------------------------------------------------
# TFRecord file IO.
# ---------------------------------------------------------------------------


def read_tfrecord_file(path: str, compression: str = "GZIP", verify_crc: bool = False):
    """Yield raw record payloads from a TFRecord file. A clipped shard (an
    interrupted copy) raises here rather than yielding a short payload."""
    opener = gzip.open if compression == "GZIP" else open
    with opener(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos < n:
        if pos + 12 > n:
            raise ValueError(
                f"truncated TFRecord: header cut at offset {pos}/{n} in {path}")
        (length,) = struct.unpack("<Q", data[pos : pos + 8])
        if verify_crc:
            (lcrc,) = struct.unpack("<I", data[pos + 8 : pos + 12])
            if masked_crc32c(data[pos : pos + 8]) != lcrc:
                raise ValueError(f"bad length crc at offset {pos} in {path}")
        pos += 12
        if pos + length + 4 > n:
            raise ValueError(
                f"truncated TFRecord: record of {length} bytes cut at offset "
                f"{pos}/{n} in {path}")
        payload = data[pos : pos + length]
        if verify_crc:
            (dcrc,) = struct.unpack("<I", data[pos + length : pos + length + 4])
            if masked_crc32c(payload) != dcrc:
                raise ValueError(f"bad data crc at offset {pos} in {path}")
        pos += length + 4
        yield payload


def write_tfrecord_file(path: str, payloads, compression: str = "GZIP") -> None:
    """Write raw record payloads as a TFRecord file (with valid masked CRCs)."""
    opener = gzip.open if compression == "GZIP" else open
    with opener(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))


def read_clip_records(path: str, timesteps: int | None = None,
                      height: int = 32, width: int = 32):
    """Yield (clip uint8 [T,H,W,3], label_byte int) pairs from one file.

    The decode of reference utils/TFRDataset.py:6-28: the 'image' feature is
    raw uint8 reshaped to [T, H, W, 3]; 'label' stays a byte string, and its
    first byte is the label (the reference's ord(), utils/engine.py:224).
    ``timesteps=None`` infers T from each record's height/width features and
    payload length.
    """
    for payload in read_tfrecord_file(path):
        feats = parse_example(payload)
        image = np.frombuffer(feats["image"][0], dtype=np.uint8)
        h = int(feats["height"][0]) if feats.get("height") else height
        w = int(feats["width"][0]) if feats.get("width") else width
        t = timesteps if timesteps is not None else image.size // (h * w * 3)
        clip = image.reshape(t, h, w, 3)
        label = feats["label"][0]
        yield clip, label[0] if len(label) else 0
