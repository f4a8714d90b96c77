"""Dataset converters, the counterpart of ``mmdgan_tpu/data/converters.py``:
numpy arrays, fixed-length binary records (CIFAR, STL) and image folders
to TFRecord files in the reference's format (raw uint8 CHW bytes under
'x', an optional int64 label under 'y'), byte for byte the JAX package's.

The reference recipes (``input_func.py:55-567``, Data/ReadMe.md):

CIFAR-10 (binary batches, label byte first; the README's quick start
keeps no label, ``save_label`` being False by default):
    binary_image_to_tfrecords(
        [f"cifar/data_batch_{i}.bin" for i in range(1, 6)],
        "cifar", 50000, (3, 32, 32), num_labels=1)
STL-10 (unlabeled_X.bin, 96x96 transposed, LANCZOS-resized to 48):
    binary_image_to_tfrecords(
        ["stl10/unlabeled_X.bin"], "stl", 100000, (3, 96, 96),
        num_labels=0, resize=(48, 48), image_transpose=True)
CelebA (png folder, aspect-preserving resize to cover (72, 88), centre
crop 64):
    raw_image_to_tfrecords(files, "celebA", resize=(72, 88),
                           crop=(64, 64), num_images_per_shard=22511)
LSUN (webp folder): raw_image_to_tfrecords(files, "lsun", resize=(64, 64),
                           crop=(64, 64), num_images_per_shard=49722)

Arrays and binary records are written by the host library
(``data/native.py``), a file's records per call, byte for byte what the
Python codec writes; PIL is imported only where an image is resized or
cropped, or read from a file.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from mmdgan_torch.data.native import NativeWriter
from mmdgan_torch.data.tfrecord import TFRecordWriter


def np_to_tfrecords(x: np.ndarray, y: Optional[np.ndarray], out_path: str,
                    num_shards: int = 1) -> List[str]:
    """Write an [N, ...] uint8 array (+ optional int labels) to tfrecords
    (input_func.py:55-103). ``out_path`` without extension; shard suffixes
    ``_<s>`` when ``num_shards`` > 1. Returns the paths."""
    if x.dtype != np.uint8:
        raise TypeError("the reference format stores raw uint8 bytes")
    n = x.shape[0]
    bounds = np.linspace(0, n, num_shards + 1).astype(int)
    rows = x.reshape(n, -1)
    paths = []
    for s in range(num_shards):
        path = f"{out_path}.tfrecords" if num_shards == 1 else f"{out_path}_{s}.tfrecords"
        lo, hi = bounds[s], bounds[s + 1]
        with NativeWriter(path) as w:
            w.write_batch(rows[lo:hi], None if y is None else np.asarray(y[lo:hi], np.int64))
        paths.append(path)
    return paths


def binary_image_to_tfrecords(
    binary_files: Sequence[str],
    out_path: str,
    num_images: int,
    image_size: Sequence[int],
    num_labels: int = 1,
    label_first: bool = True,
    resize: Optional[Sequence[int]] = None,
    crop: Optional[Sequence[int]] = None,
    image_transpose: bool = False,
    save_label: bool = False,
) -> str:
    """Fixed-length binary records (CIFAR/STL) to ``<out_path>.tfrecords``
    (input_func.py:107-226); returns the path.

    :param image_size: (C, H, W); records hold CHW uint8 pixel bytes with
        ``num_labels`` label bytes before (CIFAR) or after them.
    :param resize: target (H, W), LANCZOS (the reference's resampling)
    :param crop: PIL crop box (left, upper, right, lower)
    :param image_transpose: swap H/W (MNIST/STL store transposed images)
    :param save_label: write 'y' int64 labels
    """
    c, h, w = image_size
    rec_len = c * h * w + num_labels
    left = num_images
    path = f"{out_path}.tfrecords"
    with NativeWriter(path) as writer:
        for name in binary_files:
            if left <= 0:
                break
            raw = np.fromfile(name, np.uint8)
            n = min(len(raw) // rec_len, left)
            raw = raw[:n * rec_len].reshape(n, rec_len)
            labels = None
            if num_labels > 0:
                labels = (raw[:, 0] if label_first else raw[:, -1]).astype(np.int64)
                raw = raw[:, num_labels:] if label_first else raw[:, :-num_labels]
            img = raw.reshape(n, c, h, w)
            if image_transpose:
                img = img.transpose(0, 1, 3, 2)
            if resize is not None or crop is not None:
                img = np.stack([_pil_resize_crop(im, resize, crop) for im in img])
            writer.write_batch(np.ascontiguousarray(img).reshape(n, -1),
                               labels if save_label else None)
            left -= n
    return path


def _pil_resize_crop(img: np.ndarray, resize, crop) -> np.ndarray:
    """One CHW uint8 image resized (LANCZOS, to (H, W)) and cropped (a PIL
    box), back to CHW."""
    from PIL import Image

    im = Image.fromarray(img.transpose(1, 2, 0), "RGB")
    if resize is not None:
        im = im.resize((resize[1], resize[0]), Image.LANCZOS)
    if crop is not None:
        im = im.crop(crop)
    return np.asarray(im, np.uint8).transpose(2, 0, 1)


def raw_image_to_tfrecords(
    image_files: Sequence[str],
    out_path: str,
    resize: Optional[Sequence[int]] = None,
    crop: Optional[Sequence[int]] = None,
    num_images_per_shard: int = 20000,
    labels: Optional[Sequence[int]] = None,
    image_size: Optional[Sequence[int]] = None,
) -> List[str]:
    """Image files (png/jpg/webp; the celebA / LSUN / ImageNet recipes) to
    sharded tfrecords (input_func.py:230-337, 419-567); returns the paths.

    Reference semantics: an aspect-preserving LANCZOS resize so the image
    covers ``resize`` (scale = min over dims of src/target), then a centre
    crop to ``crop`` (H, W). Stored as CHW uint8 bytes.

    :param image_size: legacy alias for ``crop`` when crop is None.
    """
    from PIL import Image

    if crop is None and image_size is not None:
        crop = tuple(image_size)
    num_shards = max(1, int(np.ceil(len(image_files) / num_images_per_shard)))
    paths = []
    idx = 0
    for s in range(num_shards):
        path = f"{out_path}.tfrecords" if num_shards == 1 else f"{out_path}_{s:03d}.tfrecords"
        paths.append(path)
        with TFRecordWriter(path) as writer:
            for _ in range(num_images_per_shard):
                if idx >= len(image_files):
                    break
                im = Image.open(image_files[idx])
                if resize is not None:
                    w0, h0 = im.size
                    factor = min(h0 / resize[0], w0 / resize[1])
                    im = im.resize((int(round(w0 / factor)), int(round(h0 / factor))),
                                   Image.LANCZOS)
                if crop is not None:
                    w1, h1 = im.size
                    left = (w1 - crop[1]) // 2
                    top = (h1 - crop[0]) // 2
                    im = im.crop((left, top, left + crop[1], top + crop[0]))
                if im.mode != "RGB":
                    im = im.convert("RGB")
                feats = {"x": np.asarray(im, np.uint8).transpose(2, 0, 1).tobytes()}
                if labels is not None:
                    feats["y"] = np.asarray([int(labels[idx])], np.int64)
                writer.write_example(feats)
                idx += 1
    return paths
