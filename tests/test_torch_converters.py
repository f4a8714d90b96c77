"""The port's dataset converters (``data/converters.py``) against the JAX
package's on the same seeded files: every record byte-identical.

Covers the reference recipes at small sizes: CIFAR-10 binary batches
(label byte first, with and without labels, across files, cut at
``num_images``), STL-10's unlabeled binary (96x96 transposed, LANCZOS
resize to 48), a PNG folder (aspect-preserving resize to cover, centre
crop, shards, labels), and numpy arrays in shards.
"""

import os

import numpy as np
import pytest

from mmdgan_tpu.data import converters as jax_converters
from mmdgan_torch.data import converters
from mmdgan_torch.data.pipeline import ReadTFRecords


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _cifar_files(folder, n_files=3, per_file=20, seed=0):
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n_files):
        rows = np.concatenate([rng.randint(0, 10, (per_file, 1)),
                               rng.randint(0, 256, (per_file, 3 * 32 * 32))], axis=1)
        path = os.path.join(folder, f"data_batch_{i + 1}.bin")
        rows.astype(np.uint8).tofile(path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("save_label,num_images", [(False, 60), (True, 60), (True, 45)])
def test_cifar_binary_byte_identical(tmp_path, save_label, num_images):
    """The README's CIFAR-10 recipe (``save_label=False``) and a labelled
    one, over three batch files, one cut short."""
    files = _cifar_files(str(tmp_path))
    got = converters.binary_image_to_tfrecords(files, str(tmp_path / "port"), num_images,
                                               (3, 32, 32), num_labels=1,
                                               save_label=save_label)
    jax_converters.binary_image_to_tfrecords(files, str(tmp_path / "jax"), num_images,
                                             (3, 32, 32), num_labels=1, save_label=save_label)
    assert got == str(tmp_path / "port.tfrecords")
    assert _bytes(got) == _bytes(tmp_path / "jax.tfrecords")
    data = ReadTFRecords("port", num_labels=int(save_label), batch_size=num_images,
                         file_folder=str(tmp_path), num_epoch=1,
                         buffer_size=1).shape2image(3, 32, 32).load_all()
    raw = np.concatenate([np.fromfile(f, np.uint8).reshape(-1, 3073) for f in files])
    want = raw[:num_images, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(data["x"], want.astype(np.float32) / 127.5 - 1.0)
    if save_label:
        np.testing.assert_array_equal(data["y"][:, 0], raw[:num_images, 0])


def test_stl_binary_transposed_and_resized(tmp_path):
    """STL-10's recipe: no label, H and W swapped, LANCZOS to 48x48; and a
    label-last file with a crop box."""
    rng = np.random.RandomState(1)
    stl = str(tmp_path / "unlabeled_X.bin")
    rng.randint(0, 256, (5, 3 * 96 * 96)).astype(np.uint8).tofile(stl)
    kw = dict(num_labels=0, resize=(48, 48), image_transpose=True)
    converters.binary_image_to_tfrecords([stl], str(tmp_path / "port"), 5, (3, 96, 96), **kw)
    jax_converters.binary_image_to_tfrecords([stl], str(tmp_path / "jax"), 5, (3, 96, 96), **kw)
    assert _bytes(tmp_path / "port.tfrecords") == _bytes(tmp_path / "jax.tfrecords")

    last = str(tmp_path / "label_last.bin")
    np.concatenate([rng.randint(0, 256, (4, 3 * 16 * 16)), rng.randint(0, 10, (4, 1))],
                   axis=1).astype(np.uint8).tofile(last)
    kw = dict(num_labels=1, label_first=False, crop=(2, 3, 14, 11), save_label=True)
    converters.binary_image_to_tfrecords([last], str(tmp_path / "p2"), 4, (3, 16, 16), **kw)
    jax_converters.binary_image_to_tfrecords([last], str(tmp_path / "j2"), 4, (3, 16, 16), **kw)
    assert _bytes(tmp_path / "p2.tfrecords") == _bytes(tmp_path / "j2.tfrecords")


def test_png_folder_resized_cropped_sharded(tmp_path):
    """An image folder of mixed sizes and modes (RGB, L, RGBA) to three
    shards: resize to cover (20, 24), centre crop 16x16, labels."""
    from PIL import Image

    rng = np.random.RandomState(2)
    files = []
    for i, (h, w, mode) in enumerate([(40, 30, "RGB"), (33, 50, "L"), (24, 24, "RGBA"),
                                      (64, 48, "RGB"), (21, 27, "RGB")]):
        shape = (h, w) if mode == "L" else (h, w, len(mode))
        path = str(tmp_path / f"img_{i}.png")
        Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8), mode).save(path)
        files.append(path)
    labels = [3, 1, 4, 1, 5]
    kw = dict(resize=(20, 24), crop=(16, 16), num_images_per_shard=2, labels=labels)
    got = converters.raw_image_to_tfrecords(files, str(tmp_path / "port"), **kw)
    want = jax_converters.raw_image_to_tfrecords(files, str(tmp_path / "jax"), **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _bytes(g) == _bytes(w)


@pytest.mark.parametrize("labels", [True, False])
def test_np_to_tfrecords_sharded(tmp_path, labels):
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (23, 3, 4, 4)).astype(np.uint8)
    y = rng.randint(0, 7, 23) if labels else None
    got = converters.np_to_tfrecords(x, y, str(tmp_path / "port"), num_shards=3)
    want = jax_converters.np_to_tfrecords(x, y, str(tmp_path / "jax"), num_shards=3)
    assert [os.path.basename(p).replace("port", "") for p in got] == \
        [os.path.basename(p).replace("jax", "") for p in want]
    for g, w in zip(got, want):
        assert _bytes(g) == _bytes(w)
    with pytest.raises(TypeError):
        converters.np_to_tfrecords(x.astype(np.float32), None, str(tmp_path / "f"))
