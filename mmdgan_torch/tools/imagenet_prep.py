"""ImageNet preparation: extract the train tar, write one labelled record
file per class, and keep per-class inception statistics for intra-FID.
The counterpart of ``tools/imagenet_prep.py``
(``Addon/ImageNet/imagenet.py:1-149``, ``input_func.py:419-567``,
``graph_func.py:2038-2094``).

    python -m mmdgan_torch.tools.imagenet_prep extract --train-tar ILSVRC2012_img_train.tar \\
        --out-dir ./imagenet/train
    python -m mmdgan_torch.tools.imagenet_prep tfrecords --image-root ./imagenet/train \\
        --out-dir ~/mmdgan_data/imagenet --size 64
    python -m mmdgan_torch.tools.imagenet_prep ref-stats --data-dir ~/mmdgan_data/imagenet \\
        --classes 0 10 [--inception-pb graph.pb] [--device cuda]

``tfrecords`` needs PIL (imported inside the call). ``ref-stats`` runs the
classifier on the device (``cuda`` unless ``--device cpu``) and the mean
and covariance in float64 on the host. It reads every record of a class,
the last partial batch included; the JAX tool keeps only full batches
(ROADMAP C12).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tarfile


def extract_train(train_tar: str, out_dir: str) -> None:
    """The train tar holds one tar per class (imagenet.py:82-107); each is
    unpacked into ``out_dir/<wnid>``."""
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(train_tar) as outer:
        for member in outer:
            if not member.name.endswith(".tar"):
                continue
            wnid = member.name[:-4]
            class_dir = os.path.join(out_dir, wnid)
            os.makedirs(class_dir, exist_ok=True)
            with tarfile.open(fileobj=outer.extractfile(member)) as inner:
                inner.extractall(class_dir, filter="data")
            print(f"extracted {wnid}")


def build_tfrecords(image_root: str, out_dir: str, size: int) -> None:
    """One record file per class, ``imagenet_{idx:03d}.tfrecords``, with the
    class index as an int64 label (input_func.py:419-567). Each image is
    centre-cropped to ``size`` x ``size``, as the JAX tool does
    (``image_size`` is the converter's alias of ``crop``)."""
    from mmdgan_torch.data.converters import raw_image_to_tfrecords

    os.makedirs(out_dir, exist_ok=True)
    classes = sorted(d for d in os.listdir(image_root)
                     if os.path.isdir(os.path.join(image_root, d)))
    for idx, wnid in enumerate(classes):
        files = sorted(os.path.join(image_root, wnid, f)
                       for f in os.listdir(os.path.join(image_root, wnid)))
        raw_image_to_tfrecords(files, os.path.join(out_dir, f"imagenet_{idx:03d}"),
                               image_size=(size, size), labels=[idx] * len(files))
        print(f"class {idx} ({wnid}): {len(files)} images")


def class_images(data_dir: str, cls: int):
    """Every image of class ``cls`` in file order, NHWC float32 in [-1, 1];
    the side is read from the first record (square, 3 channels)."""
    import numpy as np

    from mmdgan_torch.data.pipeline import ReadTFRecords

    name = f"imagenet_{cls:03d}"
    n = ReadTFRecords(name, num_labels=1, file_folder=data_dir).load_all(limit=1)["x"].shape[1]
    side = math.isqrt(n // 3)
    if 3 * side * side != n:
        raise ValueError(f"{name}: a record of {n} values is not a square RGB image")
    x = ReadTFRecords(name, num_labels=1, file_folder=data_dir).shape2image(
        3, side, side).load_all()["x"]
    return np.ascontiguousarray(x)


def ref_stats(data_dir: str, class_lo: int, class_hi: int, batch_size: int,
              inception_pb: str = None, device=None) -> list:
    """Pool3 mean and covariance of each class, written to
    ``imagenet_{cls:03d}_stats.npz`` beside its records (graph_func.py:2038-2094);
    returns the paths."""
    import numpy as np

    from mmdgan_torch.metrics.scores import GenerativeModelMetric

    metric = GenerativeModelMetric(model="v1", model_path=inception_pb, device=device)
    paths = []
    for cls in range(class_lo, class_hi):
        x = class_images(data_dir, cls)
        batches = (x[i:i + batch_size] for i in range(0, len(x), batch_size))
        mean, cov = metric.ref_stats(batches, math.ceil(len(x) / batch_size))
        out = os.path.join(data_dir, f"imagenet_{cls:03d}_stats.npz")
        np.savez(out, mean=mean, cov=cov)
        paths.append(out)
        print(f"class {cls}: {len(x)} images, stats -> {out}")
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("extract")
    pe.add_argument("--train-tar", required=True)
    pe.add_argument("--out-dir", required=True)
    pt = sub.add_parser("tfrecords")
    pt.add_argument("--image-root", required=True)
    pt.add_argument("--out-dir", required=True)
    pt.add_argument("--size", type=int, default=64)
    pr = sub.add_parser("ref-stats")
    pr.add_argument("--data-dir", required=True)
    pr.add_argument("--classes", nargs=2, type=int, default=[0, 1000])
    pr.add_argument("--batch-size", type=int, default=64)
    pr.add_argument("--inception-pb", default=None)
    pr.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.cmd == "extract":
        extract_train(args.train_tar, args.out_dir)
    elif args.cmd == "tfrecords":
        build_tfrecords(args.image_root, args.out_dir, args.size)
    else:
        ref_stats(args.data_dir, args.classes[0], args.classes[1], args.batch_size,
                  args.inception_pb, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
