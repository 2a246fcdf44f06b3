"""The port's data path against pathtracker_tpu's: the TFRecord codec, the
native reader, shards written by either package, the dataset registry, and
the loader's batches in both orders. Records, shards and batches are held
exactly."""

import glob
import gzip
import os
import sys
import threading
from unittest import mock

import numpy as np
import pytest

from pathtracker_torch.data import legacy_dataset as tlegacy
from pathtracker_torch.data import native as tnative
from pathtracker_torch.data import pathtracker as trender
from pathtracker_torch.data import pipeline as tpipeline
from pathtracker_torch.data import presets as tpresets
from pathtracker_torch.data import registry as tregistry
from pathtracker_torch.data import tfrecord as ttf
from pathtracker_tpu.data import legacy_dataset as jlegacy
from pathtracker_tpu.data import native as jnative
from pathtracker_tpu.data import pathtracker as jrender
from pathtracker_tpu.data import pipeline as jpipeline
from pathtracker_tpu.data import presets as jpresets
from pathtracker_tpu.data import registry as jregistry
from pathtracker_tpu.data import tfrecord as jtf


def _stream(path):
    """A shard's decompressed bytes: gzip stamps the mtime into the file."""
    with gzip.open(path, "rb") as f:
        return f.read()


def _shards(root, split="*"):
    return sorted(glob.glob(os.path.join(root, f"{split}-*")))


@pytest.fixture
def codec(request, monkeypatch):
    """'native': the port's library (skipped where it cannot build);
    'python': the pure-Python codec."""
    if request.param == "native":
        if not tnative.available():
            pytest.skip("native/ptdata.cc does not build here (g++ or zlib.h missing)")
    else:
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "crc32c", lambda data: None)
    return request.param


@pytest.fixture
def same_order(request, monkeypatch):
    """Both packages on one batch order. 'python': each package's
    ``native.available`` patched to False. 'native': the port's library
    built and the JAX binding pointed at it."""
    if request.param == "native":
        if not tnative.available():
            pytest.skip("native/ptdata.cc does not build here (g++ or zlib.h missing)")
        monkeypatch.setattr(jnative, "_SO_PATHS", [str(tnative.library_path())])
        monkeypatch.setattr(jnative, "_TRIED", False)
        monkeypatch.setattr(jnative, "_LIB", None)
        assert jnative.available()
    else:
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    return request.param


BOTH = pytest.mark.parametrize("codec", ["native", "python"], indirect=True)
BOTH_ORDERS = pytest.mark.parametrize("same_order", ["native", "python"], indirect=True)


@BOTH
def test_crc32c_known_vectors(codec):
    vectors = {b"": 0x00000000, b"123456789": 0xE3069283, b"\x00" * 32: 0x8A9136AA}
    for data, want in vectors.items():
        assert ttf.crc32c(data) == want
        assert ttf.masked_crc32c(data) == jtf.masked_crc32c(data)
    blob = os.urandom(5000)
    assert ttf.crc32c(blob) == jtf._crc32c_py(blob)


def test_crc_fallback_warns_once(capsys, monkeypatch):
    """Without the native library the Python CRC warns once, on the first
    large payload; header-sized CRCs never trigger it."""
    monkeypatch.setattr(tnative, "crc32c", lambda data: None)
    monkeypatch.setattr(ttf, "_warned_slow_crc", False)
    ttf.crc32c(b"tiny")
    assert "native CRC32C" not in capsys.readouterr().out
    ttf.crc32c(b"\x00" * 5000)
    assert "native CRC32C not available" in capsys.readouterr().out
    ttf.crc32c(b"\x00" * 5000)
    assert "native CRC32C" not in capsys.readouterr().out


def test_example_roundtrip_across_packages():
    feats = {"label": b"\x01", "image": b"\x00\x01\x02\x03" * 8, "height": 32,
             "width": -32, "scores": [0.5, 1.25], "names": ["ab", b"c"]}
    buf = ttf.build_example(feats)
    assert buf == jtf.build_example(feats)
    parsed = ttf.parse_example(buf)
    assert parsed == jtf.parse_example(buf)
    assert parsed["label"] == [b"\x01"] and parsed["image"] == [feats["image"]]
    assert parsed["height"] == [32] and parsed["width"] == [-32]
    assert parsed["scores"] == [0.5, 1.25]


@BOTH
def test_tfrecord_files_cross_packages(tmp_path, codec):
    payloads = [b"abc", b"", os.urandom(1000)]
    for writer, reader in ((ttf, jtf), (jtf, ttf)):
        path = str(tmp_path / f"{writer.__name__}.tfrecord")
        writer.write_tfrecord_file(path, payloads)
        assert list(reader.read_tfrecord_file(path, verify_crc=True)) == payloads
        assert list(ttf.read_tfrecord_file(path, verify_crc=True)) == payloads
    raw = str(tmp_path / "raw.tfrecord")
    ttf.write_tfrecord_file(raw, payloads, compression="")
    assert list(jtf.read_tfrecord_file(raw, compression="", verify_crc=True)) == payloads


@BOTH
def test_truncated_shard_fails_loudly(tmp_path, codec):
    """A clipped shard raises in the Python codec and in the native reader;
    the intact shard reads whole through both."""
    root = trender.make_synthetic_dataset(str(tmp_path / "ds"), n_train=6,
                                          n_test=2, timesteps=4, shards=1)
    path = os.path.join(root, "train-00000-of-00001.tfrecord")
    raw = _stream(path)
    cut = os.path.join(root, "cut.tfrecord")
    with gzip.open(cut, "wb") as f:  # inner framing cut, gzip member valid
        f.write(raw[: len(raw) - 100])
    half = os.path.join(root, "half.tfrecord")  # the gzip member itself cut
    with open(path, "rb") as f:
        blob = f.read()
    with open(half, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="truncated TFRecord"):
        list(ttf.read_tfrecord_file(cut))
    assert len(list(ttf.read_tfrecord_file(path))) == 6
    if codec == "native":
        for bad in (cut, half):
            with pytest.raises(IOError):
                tnative.ShardView(bad, 4, 32, 32)
        with tnative.ShardView(path, 4, 32, 32) as sv:
            assert len(sv) == 6


@BOTH
def test_shards_decode_the_same_in_both_packages(tmp_path, codec):
    """Both packages render the same shards (decompressed streams equal,
    including empty shards), and each decodes the other's to the same
    records."""
    kw = dict(n_train=5, n_test=3, timesteps=6, n_distractors=3, speed=2.0,
              shards=2, seed=11)
    ours = trender.make_synthetic_dataset(str(tmp_path / "t"), **kw)
    theirs = jrender.make_synthetic_dataset(str(tmp_path / "j"), **kw)
    names = [os.path.basename(p) for p in _shards(ours)]
    assert names == [os.path.basename(p) for p in _shards(theirs)]
    assert "test-00001-of-00002.tfrecord" in names
    for name in names:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        assert _stream(a) == _stream(b)
        want = [(c.tobytes(), int(y)) for c, y in jtf.read_clip_records(a)]
        assert [(c.tobytes(), int(y)) for c, y in ttf.read_clip_records(b)] == want
        if codec == "native":
            got = [(c.tobytes(), y) for c, y in tnative.read_clip_records(b, 6)]
            assert got == want


def test_renderer_cli(tmp_path, capsys):
    argv = ["pathtracker", "--root", str(tmp_path / "cli"), "--train", "2",
            "--test", "1", "--length", "3", "--dist", "2", "--shards", "1"]
    with mock.patch.object(sys, "argv", argv):
        trender._main()
    assert "wrote 2+1 clips (T=3, dist=2, speed=1)" in capsys.readouterr().out
    want = jrender.make_synthetic_dataset(str(tmp_path / "j"), n_train=2, n_test=1,
                                          timesteps=3, n_distractors=2, shards=1)
    for a, b in zip(_shards(str(tmp_path / "cli")), _shards(want)):
        assert _stream(a) == _stream(b)


def test_registry_renders_the_same_root_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", "6")
    monkeypatch.setenv("PATHTRACKER_SYNTH_TEST", "6")
    assert tregistry.ALL_DATASETS == jregistry.ALL_DATASETS
    assert tregistry.HUMAN_DATASETS == jregistry.HUMAN_DATASETS
    results = {}
    for name, reg in (("t", tregistry), ("j", jregistry)):
        monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / name))
        results[name] = reg.dataset_selector(3, 1, 4)
        assert reg.dataset_selector(3, 1, 4) == results[name]  # found, not re-rendered
        if name == "t":
            with pytest.raises(FileNotFoundError):
                reg.dataset_selector(2, 1, 4, synthesize_missing=False)
            with pytest.raises(KeyError):
                reg.human_dataset_selector("gen_9")
    (root_t, *rest_t), (root_j, *rest_j) = results["t"], results["j"]
    assert rest_t == rest_j == [4, 6, 6]
    assert os.path.relpath(root_t, tmp_path / "t") == os.path.relpath(root_j, tmp_path / "j")
    files = [os.path.basename(p) for p in _shards(root_t)]
    assert files == [os.path.basename(p) for p in _shards(root_j)]
    for name in files:
        assert _stream(os.path.join(root_t, name)) == _stream(os.path.join(root_j, name))
    for name, reg, root in (("t", tregistry, root_t), ("j", jregistry, root_j)):
        monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / name))
        with open(os.path.join(root, "COUNTS"), "w") as f:
            f.write("20000 2500")
        assert reg.dataset_selector(3, 1, 4)[2:] == (20000, 2500)


def _batches(loader, epochs=2):
    return [(c.copy(), y.copy()) for _ in range(epochs) for c, y in loader]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (gc, gy), (wc, wy) in zip(got, want):
        assert gc.dtype == wc.dtype == np.uint8 and gy.dtype == wy.dtype == np.uint8
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gy, wy)


@pytest.fixture(scope="module")
def three_shards(tmp_path_factory):
    return trender.make_synthetic_dataset(
        str(tmp_path_factory.mktemp("shards")), n_train=23, n_test=0, timesteps=3,
        n_distractors=2, shards=3, seed=5)


@BOTH_ORDERS
@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle_buffer=5, seed=3),
    dict(batch_size=5, shuffle_buffer=1000, seed=0, drop_remainder=False),
    dict(batch_size=3, shuffle_buffer=0),
], ids=["buffer5", "buffer1000-remainder", "unshuffled"])
def test_batches_match_jax(three_shards, same_order, kw):
    """The same files and seed give the same batches, epoch after epoch."""
    pattern = os.path.join(three_shards, "train-*")
    got = _batches(tpipeline.tfr_data_loader(pattern, timesteps=3, **kw))
    want = _batches(jpipeline.tfr_data_loader(pattern, timesteps=3, **kw))
    _assert_same_batches(got, want)
    assert sum(len(y) for _, y in got) == 2 * (23 if kw.get("drop_remainder") is False
                                               else 23 - 23 % kw["batch_size"])


@BOTH_ORDERS
@pytest.mark.parametrize("n_train,shards,count", [(16, 4, 2), (16, 4, 8), (18, 2, 4)],
                         ids=["files", "records", "records-uneven"])
def test_striding_matches_jax(tmp_path, same_order, n_train, shards, count):
    """shard_index/shard_count: file round-robin when files >= processes,
    else global record striding with the final incomplete block dropped;
    every process gets the same records in the same order as in JAX, the
    slices are disjoint and, striding, all of one size."""
    root = trender.make_synthetic_dataset(str(tmp_path), n_train=n_train,
                                          n_test=0, timesteps=4, shards=shards)
    pattern = os.path.join(root, "train-*")
    parts = []
    for rank in range(count):
        for shuffle, seed in ((0, None), (50, 7)):
            kw = dict(batch_size=1, timesteps=4, shuffle_buffer=shuffle, seed=seed,
                      shard_index=rank, shard_count=count)
            got = _batches(tpipeline.tfr_data_loader(pattern, **kw))
            _assert_same_batches(got, _batches(jpipeline.tfr_data_loader(pattern, **kw)))
            if shuffle == 0:
                parts.append({c.tobytes() for c, _ in got})
    assert sum(len(p) for p in parts) == len(set().union(*parts))
    if count > shards:
        assert len({len(p) for p in parts}) == 1
        assert len(set().union(*parts)) == n_train - n_train % count
    else:
        assert len(set().union(*parts)) == n_train


def test_native_reader_matches_python_codec(three_shards):
    if not tnative.available():
        pytest.skip("native/ptdata.cc does not build here (g++ or zlib.h missing)")
    for path in _shards(three_shards, "train"):
        py = list(ttf.read_clip_records(path, 3))
        with tnative.ShardView(path, timesteps=3) as shard:
            assert len(shard) == len(py)
            for i, (clip, label) in enumerate(py):
                np.testing.assert_array_equal(shard.clips[i], clip)
                assert int(shard.labels[i]) == label
    with pytest.raises(IOError):  # wrong clip size: no record parses
        tnative.ShardView(_shards(three_shards, "train")[0], timesteps=4)


def test_shard_view_copies_survive_close(three_shards):
    """The library pools decode buffers: a view kept past close() becomes
    the next shard's clips, a copy stays the same."""
    if not tnative.available():
        pytest.skip("native/ptdata.cc does not build here (g++ or zlib.h missing)")
    first, second = _shards(three_shards, "train")[:2]
    with tnative.ShardView(first, timesteps=3) as sv:
        kept = sv.clips[[0, 1]]
        labels = sv.labels.copy()
    with tnative.ShardView(second, timesteps=3):
        pass
    want = list(ttf.read_clip_records(first, 3))
    np.testing.assert_array_equal(kept, np.stack([c for c, _ in want[:2]]))
    np.testing.assert_array_equal(labels, [y for _, y in want])


def test_first_use_from_many_threads_binds_once(monkeypatch):
    """Loaders may first reach the library from their own threads: it is
    built and bound once, and every caller sees it."""
    if not tnative.available():
        pytest.skip("native/ptdata.cc does not build here (g++ or zlib.h missing)")
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "_LIB", None)
    binds, seen = [], []
    bind = tnative._bind
    monkeypatch.setattr(tnative, "_bind", lambda path: binds.append(path) or bind(path))
    threads = [threading.Thread(target=lambda: seen.append(tnative.available()))
               for _ in range(32)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert seen == [True] * 32 and len(binds) == 1


def test_producer_errors_reach_the_consumer(tmp_path, monkeypatch):
    bad = tmp_path / "train-00000-of-00001.tfrecord"
    with gzip.open(bad, "wb") as f:
        f.write(b"\x05" * 7)
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(ValueError, match="truncated TFRecord"):
        list(tpipeline.tfr_data_loader(str(tmp_path / "train-*"), timesteps=1))
    with pytest.raises(ValueError, match="no input files"):
        tpipeline.tfr_data_loader(str(tmp_path / "none-*"))
    with pytest.raises(ValueError, match="shard_index"):
        tpipeline.tfr_data_loader(str(bad), shard_index=2, shard_count=2)


def test_transforms_presets_and_legacy_dataset_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 256, size=(4, 16, 16, 3), dtype=np.uint8)
    for flip in range(4):
        for t_cls, j_cls in ((tpresets.VideoClassificationPresetTrain,
                              jpresets.VideoClassificationPresetTrain),):
            np.testing.assert_array_equal(t_cls(resize_size=8, flip_index=flip)(clip),
                                          j_cls(resize_size=8, flip_index=flip)(clip))
    np.testing.assert_array_equal(tpresets.VideoClassificationPresetEval(8)(clip),
                                  jpresets.VideoClassificationPresetEval(8)(clip))
    video = tmp_path / "v0"
    video.mkdir()
    for i in range(4):
        np.save(video / f"{i + 1:05d}.png.npy", clip[i])
    lst = tmp_path / "list.txt"
    lst.write_text("v0 4 1\nv0 4 0\n")
    ours = tlegacy.DataSetPol(str(tmp_path), str(lst), use_augmentations=True)
    theirs = jlegacy.DataSetPol(str(tmp_path), str(lst), use_augmentations=True)
    assert len(ours) == len(theirs) == 2
    for (a, ya), (b, yb) in zip(ours, theirs):
        assert ya == yb
        np.testing.assert_array_equal(a, b)
