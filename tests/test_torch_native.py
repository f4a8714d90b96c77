"""The port's host record reader (``csrc/tfrec.cc``, ``data/native.py``)
against the JAX package's (``native/tfrec.cc``, ``mmdgan_tpu/data/native.py``)
and the Python codec, and ``ReadTFRecords(use_native=...)``.

Everything here is exact: records byte for byte, crc32c values equal,
batches bitwise equal. The library is built with g++ on this machine, into
the port's ``build/`` (or a test's own directory where a build must fail).
"""

import numpy as np
import pytest

from mmdgan_tpu.data.native import NativeWriter as JaxNativeWriter
from mmdgan_tpu.data.native import crc32c_native as jax_crc32c_native
from mmdgan_tpu.data.pipeline import ReadTFRecords as JaxReadTFRecords
from mmdgan_torch.data import native
from mmdgan_torch.data.pipeline import ReadTFRecords
from mmdgan_torch.data.tfrecord import TFRecordReader, TFRecordWriter, crc32c, parse_example
from mmdgan_torch.ops import _build

N, CHW = 150, (3, 8, 8)


def _records(seed=0, n=N, labels=True):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (n, *CHW)).astype(np.uint8)
    y = rng.randint(0, 10, n).astype(np.int64) if labels else None
    return x, y


def _python_file(path, x, y):
    with TFRecordWriter(path) as w:
        for i in range(len(x)):
            feats = {"x": x[i].tobytes()}
            if y is not None:
                feats["y"] = np.asarray([y[i]], np.int64)
            w.write_example(feats)
    return path


def test_library_builds_into_the_build_directory():
    native.get_lib()
    path = _build.build(native.SOURCE)   # the built file: no compiler runs again
    assert path.exists() and path.name.startswith("tfrec-") and path.suffix == ".so"
    assert "march" not in " ".join(_build.HOST_FLAGS)


@pytest.mark.parametrize("labels", [True, False])
def test_writers_are_byte_identical(tmp_path, labels):
    """The port's native writer, JAX's native writer and the Python writer
    write the same bytes."""
    x, y = _records(labels=labels)
    rows = x.reshape(N, -1)
    with native.NativeWriter(str(tmp_path / "port.tfrecords")) as w:
        w.write_batch(rows[:70], None if y is None else y[:70])
        w.write_batch(rows[70:], None if y is None else y[70:])
    with JaxNativeWriter(str(tmp_path / "jax.tfrecords")) as w:
        w.write_batch(rows, y)
    _python_file(str(tmp_path / "py.tfrecords"), x, y)
    port, jax_, py = (open(tmp_path / f"{n}.tfrecords", "rb").read()
                      for n in ("port", "jax", "py"))
    assert port == jax_ == py


@pytest.mark.parametrize("writer", ["jax_native", "python"])
def test_reader_reads_every_writer(tmp_path, writer):
    """NativeRecordIterator yields each record's x bytes and y as the
    Python codec parses them, from JAX's writer and the port's Python one;
    a one-byte start capacity forces the regrow-and-reread path."""
    x, y = _records(seed=1)
    path = str(tmp_path / "r.tfrecords")
    if writer == "jax_native":
        with JaxNativeWriter(path) as w:
            w.write_batch(x.reshape(N, -1), y)
    else:
        _python_file(path, x, y)
    want = [parse_example(r) for r in TFRecordReader(path, verify_crc=True)]
    for capacity in (None, 1, len(x[0].tobytes())):
        got = list(native.NativeRecordIterator(path, verify_crc=True, capacity=capacity))
        assert len(got) == len(want) == N
        for g, w in zip(got, want):
            assert g["x"] == w["x"]
            np.testing.assert_array_equal(g["y"], w["y"])
            assert g["y"].dtype == np.int64


def test_unlabelled_records_have_no_y(tmp_path):
    x, _ = _records(labels=False)
    path = _python_file(str(tmp_path / "u.tfrecords"), x, None)
    got = list(native.NativeRecordIterator(path))
    assert len(got) == N and all(set(g) == {"x"} for g in got)


def test_corrupt_record_raises_with_crc_check(tmp_path):
    x, y = _records()
    path = _python_file(str(tmp_path / "c.tfrecords"), x, y)
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="parse error"):
        list(native.NativeRecordIterator(path, verify_crc=True))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 4099])
def test_crc32c_matches_jax_and_python(n):
    data = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8).tobytes()
    assert native.crc32c_native(data) == jax_crc32c_native(data) == crc32c(data)
    lib = native.get_lib()
    arr = np.frombuffer(data or b"\0", np.uint8)
    masked = lib.tfrec_masked_crc32c(arr.ctypes.data_as(native._U8P), n)
    c = crc32c(data)
    assert masked == ((((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _pipes(folder, **kw):
    common = dict(num_labels=1, batch_size=8, file_folder=folder, num_epoch=2, seed=5, **kw)
    return (ReadTFRecords("a", use_native=True, **common),
            ReadTFRecords("a", use_native=False, **common),
            JaxReadTFRecords(["a"], use_native=True, **common))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["x"].dtype == w["x"].dtype
        np.testing.assert_array_equal(g["x"], w["x"])
        np.testing.assert_array_equal(g["y"], w["y"])


@pytest.mark.parametrize("case", ["shuffle_skip_repeat", "same_class", "device_decode",
                                  "no_buffer", "features"])
def test_pipeline_batches_bitwise_with_and_without_native(tmp_path, case):
    """ReadTFRecords batches with the native reader, with the Python reader
    and with JAX's native reader are bitwise equal: shuffle buffer, skip,
    two epochs, same-class batching, uint8 device-decode batches, and
    flat features."""
    x, y = _records(seed=2)
    _python_file(str(tmp_path / "a.tfrecords"), x, y)
    kw = dict(skip_count=3, buffer_size=32)
    if case == "device_decode":
        kw["device_decode"] = True
    if case == "no_buffer":
        kw = dict(buffer_size=1)
    port, python, jax_ = _pipes(str(tmp_path), **kw)
    if case == "features":
        for p in (port, python, jax_):
            p.num_features = int(np.prod(CHW))
    else:
        for p in (port, python, jax_):
            p.shape2image(*CHW)
    same = case == "same_class"
    got = list(port.next_batch(same))
    _assert_batches_equal(got, list(python.next_batch(same)))
    _assert_batches_equal(got, list(jax_.next_batch(same)))
    if same:
        assert all(len(np.unique(b["y"])) == 1 for b in got)


@pytest.mark.parametrize("files", [1, 3])
def test_sharded_pipeline_bitwise(tmp_path, files):
    """Each of three ranks' shards (records dealt round-robin from one
    file, or whole files) reads the same with either reader, and the
    native reader's load_all matches the Python one's."""
    x, y = _records(seed=3)
    names = [f"s{i}" for i in range(files)]
    for i, name in enumerate(names):
        _python_file(str(tmp_path / f"{name}.tfrecords"), x[i::files], y[i::files])
    for rank in range(3):
        pipes = [ReadTFRecords(names, num_labels=1, batch_size=4, file_folder=str(tmp_path),
                               num_epoch=1, buffer_size=1, use_native=use).shard(3, rank)
                 .shape2image(*CHW) for use in (True, False)]
        _assert_batches_equal(list(pipes[0].next_batch()), list(pipes[1].next_batch()))
        a, b = (p.load_all() for p in pipes)
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])


def test_failed_build_raises_naming_the_python_reader(tmp_path, monkeypatch):
    """With no compiler on PATH and no library built, reading raises and
    names use_native=False; it never falls back. use_native=False reads."""
    x, y = _records()
    _python_file(str(tmp_path / "a.tfrecords"), x, y)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.delenv(_build.CACHE_ENV, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    pipe = ReadTFRecords("a", num_labels=1, batch_size=8, file_folder=str(tmp_path),
                         num_epoch=1).shape2image(*CHW)
    with pytest.raises(RuntimeError, match="use_native=False") as err:
        next(pipe.next_batch())
    assert "g++ not found" in str(err.value)
    pipe = ReadTFRecords("a", num_labels=1, batch_size=8, file_folder=str(tmp_path),
                         num_epoch=1, use_native=False).shape2image(*CHW)
    assert next(pipe.next_batch())["x"].shape == (8, 8, 8, 3)
    assert not list((tmp_path / "empty_build").glob("*.so"))
