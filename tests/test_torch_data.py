"""The port's data side against the JAX package's: the shuffled-epochs
layouts of ``EpochPermuter``, the device-data samplers, and tfrecords
written by one package and read by the other. Everything here is exact:
the same rows in the same order, bit for bit."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.data import ReadTFRecords as JaxReadTFRecords
from mmdgan_tpu.data import TFRecordReader as JaxTFRecordReader
from mmdgan_tpu.data import np_to_tfrecords as jax_np_to_tfrecords
from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.train.optim import multi_opt_config as jax_multi_opt_config
from mmdgan_tpu.train.step import EpochPermuter as JaxEpochPermuter
from mmdgan_tpu.train.step import build_device_data_step as jax_build_device_data_step
from mmdgan_torch.data.pipeline import ReadTFRecords
from mmdgan_torch.data.prefetch import background, prefetch
from mmdgan_torch.data.tfrecord import TFRecordReader, crc32c, np_to_tfrecords
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.parallel import DataParallel, make_mesh_2d
from mmdgan_torch.parallel.mesh import init_distributed
from mmdgan_torch.train.optim import multi_opt_config
from mmdgan_torch.train.step import EpochPermuter, build_device_data_step

torch.set_num_threads(1)

ARCH = {
    "input": [(1, 8, 8)],
    "code": [(8, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 8, "op": "d", "act": "tanh", "act_nm": None,
         "out_reshape": [1, 8, 8]}],
    "discriminator": [
        {"name": "l1", "out": 4, "op": "d", "act": "lrelu", "w_nm": "s", "act_k": 1.0,
         "in_reshape": [8 * 8]}],
}
N, B = 40, 8


def _dataset():
    return np.random.RandomState(0).randint(0, 256, size=(N, 8, 8, 1), dtype=np.uint8)


def test_epoch_permuter_layouts_match_jax():
    """Epochs 0-4 in turn, then a fresh permuter jumping to epoch 3 (a
    resume): every layout bitwise equal to JAX's."""
    x = _dataset()
    jax_p, port_p = JaxEpochPermuter.single_device(N, 5), EpochPermuter.single_device(N, 5)
    j_arr, t_arr = jnp.asarray(x), torch.tensor(x)
    for e in range(5):
        (j_arr,) = jax_p.advance(e, [j_arr])
        port_p.advance(e, [t_arr])
        np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr), err_msg=f"epoch {e}")
    (j3,) = JaxEpochPermuter.single_device(N, 5).advance(3, [jnp.asarray(x)])
    t3 = torch.tensor(x)
    EpochPermuter.single_device(N, 5).advance(3, [t3])
    np.testing.assert_array_equal(t3.numpy(), np.asarray(j3))
    # back to epoch 0 restores the original rows
    port_p.advance(0, [t_arr])
    np.testing.assert_array_equal(t_arr.numpy(), x)


def _samplers(sampling):
    jmodel = JaxSNGan(ARCH)
    jopt_d, jopt_g = jax_multi_opt_config([1e-3, 1e-3])
    model = SNGan(ARCH, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    jfn = jax_build_device_data_step(jmodel, jopt_d, jopt_g, 2, B, sampling=sampling)
    fn = build_device_data_step(model, opt_d, opt_g, 2, B, sampling=sampling, device="cpu")
    return jfn, fn


def test_shuffled_epochs_batches_match_jax():
    x = _dataset()
    jfn, fn = _samplers("shuffled_epochs")
    jsample, sample = jfn.sampler(jnp.asarray(x)), fn.sampler(torch.tensor(x))
    for step in (0, 1, 4, 5, 7, 13, 1001):
        want = np.asarray(jsample(None, jnp.asarray(step, jnp.int32))["x"])
        got = sample(None, torch.tensor(step, dtype=torch.int32))["x"].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")


def test_uniform_draws_are_in_range_and_move():
    x = np.arange(N, dtype=np.uint8).reshape(N, 1, 1, 1) * np.ones((1, 8, 8, 1), np.uint8)
    _, fn = _samplers("uniform")
    sample = fn.sampler(torch.tensor(x))
    rng = torch.Generator().manual_seed(3)
    rows = [sample(rng, torch.tensor(s))["x"][:, 0, 0, 0].numpy() for s in range(4)]
    for r in rows:
        assert r.shape == (B,) and r.min() >= 0 and r.max() < N
    assert all(not np.array_equal(rows[0], r) for r in rows[1:])
    assert len(np.unique(np.concatenate(rows))) > B


def test_unported_sampling_options_raise(tmp_path):
    """The 2-D mesh builds, and its device-data window raises the JAX
    package's message (``mmdgan_tpu/train/trainer.py:605-607``: the
    sampler shards rows over the data axis only); ``with_mesh(None)`` is
    the single-device window; same-class sampling raises without its class
    tables; a labelled dataset is sampled with its labels."""
    model = SNGan(ARCH, device="cpu")
    opt_d, opt_g = multi_opt_config([1e-3, 1e-3])
    with pytest.raises(ValueError, match="same_class_tables"):
        build_device_data_step(model, opt_d, opt_g, 2, B, same_class=True, device="cpu")
    # micro-batches are ported: a count that does not split the batch raises
    with pytest.raises(ValueError, match="micro-batches"):
        build_device_data_step(model, opt_d, opt_g, 2, B, micro_batches=3, device="cpu")
    fn = build_device_data_step(model, opt_d, opt_g, 2, B, device="cpu")
    assert fn.with_mesh(None).dp is None
    init_distributed("gloo", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        dp = DataParallel(make_mesh_2d(1, 1), device="cpu")
        assert (dp.axis, dp.model_axis, dp.size, dp.model.size) == ("data", "model", 1, 1)
        with pytest.raises(ValueError, match="HBM-resident datasets are data-parallel only"):
            fn.with_mesh(dp)
    finally:
        torch.distributed.destroy_process_group()
    data_y = torch.arange(N).reshape(N, 1)
    batch = fn.sampler(torch.arange(N, dtype=torch.float32).reshape(N, 1, 1, 1).expand(
        N, 8, 8, 1), data_y)(torch.Generator().manual_seed(0), torch.tensor(0))
    assert torch.equal(batch["y"][:, 0].float(), batch["x"][:, 0, 0, 0])


def _images(n=24, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(n, 3, 8, 8), dtype=np.uint8), rng.randint(0, 4, size=n)


@pytest.mark.parametrize("device_decode", [True, False])
def test_jax_written_tfrecords_load_bitwise_in_both(tmp_path, device_decode):
    x, y = _images()
    jax_np_to_tfrecords(x, y, str(tmp_path / "img"))
    kw = dict(batch_size=8, file_folder=str(tmp_path), device_decode=device_decode)
    want = JaxReadTFRecords("img", num_labels=1, use_native=False, **kw).shape2image(
        3, 8, 8).load_all()
    got = ReadTFRecords("img", num_labels=1, **kw).shape2image(3, 8, 8).load_all()
    assert got["x"].dtype == want["x"].dtype == (np.uint8 if device_decode else np.float32)
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_array_equal(got["y"], want["y"])
    if device_decode:
        np.testing.assert_array_equal(got["x"], x.transpose(0, 2, 3, 1))


def test_port_written_tfrecords_read_by_jax(tmp_path):
    x, y = _images(seed=1)
    path = np_to_tfrecords(x, y, str(tmp_path / "port"))
    with open(path, "rb") as f:
        port_bytes = f.read()
    jax_np_to_tfrecords(x, y, str(tmp_path / "jax"))
    with open(tmp_path / "jax.tfrecords", "rb") as f:
        assert f.read() == port_bytes
    records = list(JaxTFRecordReader(path, verify_crc=True).examples())
    assert len(records) == len(x)
    for i, ex in enumerate(records):
        assert ex["x"] == x[i].tobytes()
        np.testing.assert_array_equal(ex["y"], [y[i]])
    assert [r["x"] for r in TFRecordReader(path, verify_crc=True).examples()] == [
        r["x"] for r in records]
    assert crc32c(b"123456789") == 0xE3069283   # the CRC-32C check value


def test_pipeline_batches_and_prefetch(tmp_path):
    """Host batches through the thread and the CPU prefetcher: NHWC, in
    file order with a buffer of one, repeating after the last file."""
    x, _ = _images(n=10)
    np_to_tfrecords(x, None, str(tmp_path / "img"))
    pipe = ReadTFRecords("img", batch_size=4, file_folder=str(tmp_path), buffer_size=1,
                         device_decode=True).shape2image(3, 8, 8)
    it = prefetch(pipe.next_batch(), "cpu")
    batches = [next(it) for _ in range(5)]
    rows = torch.cat([b["x"] for b in batches]).numpy()
    assert rows.shape == (20, 8, 8, 3) and batches[0]["y"] is None
    np.testing.assert_array_equal(rows[:10], x.transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(rows[10:], x.transpose(0, 2, 3, 1))


def test_background_forwards_errors():
    def failing():
        yield 1
        raise OSError("disk gone")

    it = background(failing(), 2)
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_background_close_waits_for_its_thread():
    """Closing the iterator of an endless source ends its producer thread
    before ``close`` returns (a thread still pinning a batch when the
    process exits aborts it)."""
    import itertools
    import threading

    before = set(threading.enumerate())
    it = background(itertools.count(), 2)
    assert next(it) == 0
    (producer,) = set(threading.enumerate()) - before
    it.close()
    assert not producer.is_alive()


def test_missing_tfrecord_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ReadTFRecords("absent", file_folder=str(tmp_path))
    assert not os.listdir(tmp_path)
