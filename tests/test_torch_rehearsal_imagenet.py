"""The port's ``tools/inception_rehearsal.py`` and ``tools/imagenet_prep.py``
(``mmdgan_torch/tools``) against the JAX package's tools of the same name.

- The rehearsal's CLI entry runs on the CPU over a port checkpoint that
  ``tools/quality_smoke.py --ckpt-dir`` wrote, at ``--eval-batches 2
  --batch 4``, its cross-check against TensorFlow running the twin graph:
  exit 0 and the JAX tool's keys.
- ImageNet prep on a tar of PNGs written here: ``extract`` gives the JAX
  tool's directory tree, ``tfrecords`` its record files byte for byte, and
  ``ref-stats`` its per-class mean and covariance at rtol 1e-4 where every
  class fills whole batches. With a partial last batch the port's
  statistics cover every image and JAX's drop the remainder (ROADMAP C12).
"""

import io
import json
import os
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mmdgan_torch.tools import (  # noqa: E402
    imagenet_prep,
    inception_rehearsal,
    make_fake_inception,
    quality_smoke,
)
from tools import imagenet_prep as jax_prep  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _two_blas_threads():
    """Two BLAS threads: the FID's 2048-wide SVDs thrash a host shared by
    six test workers (as in tests/test_torch_eval_cli.py)."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=2):
        yield


# tools/inception_rehearsal.py:147-163
JAX_KEYS = {"metric", "pb", "ckpt_step", "samples", "is_x", "is_g", "fid_xx", "fid_xg",
            "crosscheck_max_rel_diff", "eval_seconds", "images_per_sec", "note"}


@pytest.fixture(scope="module")
def fake_pb(tmp_path_factory):
    pb = str(tmp_path_factory.mktemp("pb") / "fake_inception_v1.pb")
    make_fake_inception.write(pb, seed=0)
    return pb


def test_rehearsal_on_a_port_checkpoint_crosschecked_against_tf(tmp_path, fake_pb, capsys):
    from mmdgan_tpu.metrics.inception import FrozenGraphClassifier as JaxClassifier

    ckpt = str(tmp_path / "ckpt")
    assert quality_smoke.main(
        ["--device", "cpu", "--compute-dtype", "float32", "--loss", "rmb", "--steps", "2",
         "--eval-every", "2", "--scan-k", "2", "--batch", "4", "--eval-batches", "1",
         "--ckpt-dir", ckpt, "--out", str(tmp_path / "out")]) == 0
    assert "RESUMABLE" in capsys.readouterr().out
    twin = make_fake_inception.twin_path(fake_pb)
    assert inception_rehearsal.main(
        ["--device", "cpu", "--pb", fake_pb, "--ckpt-dir", ckpt,
         "--eval-batches", "2", "--batch", "4"],
        reference=JaxClassifier(twin, backend="tf")) == 0
    out = capsys.readouterr().out
    assert "vs the given reference cross-check" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert JAX_KEYS <= set(line) and line["samples"] == 8 and line["ckpt_step"] == 2
    assert 0 <= line["crosscheck_max_rel_diff"] < 1e-4
    assert all(np.isfinite(line[k]) for k in ("is_x", "is_g", "fid_xx", "fid_xg"))
    assert set(line["seconds_by_part"]) == {"data", "generation", "classifier", "fid"}


def test_rehearsal_gate_refuses_a_classifier_that_disagrees(fake_pb):
    def off(images):
        logits, pool3 = FrozenGraphClassifier(fake_pb, device="cpu")(images)
        return logits * 1.001, pool3

    from mmdgan_torch.metrics.inception import FrozenGraphClassifier

    gap = inception_rehearsal.crosscheck(fake_pb, "cpu", 2, 1, reference=off)
    assert 1e-4 < gap < 2e-3


def _png_tar(tmp_path, sizes):
    """A train tar of one tar per class, each of PNGs of ``sizes`` (w, h)."""
    from PIL import Image

    rng = np.random.RandomState(3)
    outer = tmp_path / "train.tar"
    with tarfile.open(outer, "w") as tar:
        for c, class_sizes in enumerate(sizes):
            inner = io.BytesIO()
            with tarfile.open(fileobj=inner, mode="w") as t:
                for i, (w, h) in enumerate(class_sizes):
                    png = io.BytesIO()
                    mode = "L" if i == 1 else "RGB"
                    shape = (h, w) if mode == "L" else (h, w, 3)
                    Image.fromarray(rng.randint(0, 256, shape, np.uint8), mode).save(png, "PNG")
                    info = tarfile.TarInfo(f"n0{c}_{i}.png")
                    info.size = len(png.getvalue())
                    t.addfile(info, io.BytesIO(png.getvalue()))
            info = tarfile.TarInfo(f"n0{c}.tar")
            info.size = len(inner.getvalue())
            tar.addfile(info, io.BytesIO(inner.getvalue()))
    return str(outer)


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): Path(d, f).read_bytes()
            for d, _, files in os.walk(root) for f in files}


def test_imagenet_prep_matches_jax(tmp_path, fake_pb, capsys):
    sizes = [[(40, 30), (24, 24), (30, 50), (16, 16)], [(33, 33)] * 4, [(20, 40)] * 4]
    outer = _png_tar(tmp_path, sizes)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert imagenet_prep.main(["extract", "--train-tar", outer, "--out-dir", ours]) == 0
    jax_prep.extract_train(outer, theirs)
    assert _tree(ours) == _tree(theirs) and len(_tree(ours)) == 12

    rec_ours, rec_theirs = str(tmp_path / "rec_ours"), str(tmp_path / "rec_theirs")
    assert imagenet_prep.main(["tfrecords", "--image-root", ours, "--out-dir", rec_ours,
                               "--size", "24"]) == 0
    jax_prep.build_tfrecords(theirs, rec_theirs, 24)
    assert _tree(rec_ours) == _tree(rec_theirs)
    assert sorted(_tree(rec_ours)) == [f"imagenet_{c:03d}.tfrecords" for c in range(3)]

    # four images a class, batches of 2: JAX keeps every image too
    assert imagenet_prep.main(["ref-stats", "--data-dir", rec_ours, "--classes", "0", "3",
                               "--batch-size", "2", "--inception-pb", fake_pb,
                               "--device", "cpu"]) == 0
    jax_prep.ref_stats(rec_theirs, 0, 3, 2, fake_pb)
    for c in range(3):
        got = np.load(os.path.join(rec_ours, f"imagenet_{c:03d}_stats.npz"))
        want = np.load(os.path.join(rec_theirs, f"imagenet_{c:03d}_stats.npz"))
        assert got["mean"].shape == (2048,) and got["cov"].shape == (2048, 2048)
        # atol: entries near 0 of a 2048-wide covariance of four samples,
        # from float32 features that the two executors sum in other orders
        np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["cov"], want["cov"], rtol=1e-4, atol=1e-6)
    capsys.readouterr()


def test_ref_stats_cover_the_last_partial_batch(tmp_path, fake_pb):
    """Five images, batches of 2: the port's statistics are those of all
    five (JAX's ``ref_stats`` keeps the two full batches, ROADMAP C12)."""
    from mmdgan_torch.data.tfrecord import np_to_tfrecords
    from mmdgan_torch.metrics.fid import mean_cov_np
    from mmdgan_torch.metrics.inception import FrozenGraphClassifier

    x = np.random.RandomState(5).randint(0, 256, (5, 3, 16, 16), np.uint8)
    np_to_tfrecords(x, np.zeros(5), str(tmp_path / "imagenet_000"))
    assert imagenet_prep.class_images(str(tmp_path), 0).shape == (5, 16, 16, 3)
    path, = imagenet_prep.ref_stats(str(tmp_path), 0, 1, 2, fake_pb, device="cpu")
    images = x.transpose(0, 2, 3, 1).astype(np.float32) / 127.5 - 1.0
    pool = FrozenGraphClassifier(fake_pb, device="cpu")(images)[1].numpy()
    mean, cov = mean_cov_np(pool)
    got = np.load(path)
    np.testing.assert_allclose(got["mean"], mean, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["cov"], cov, rtol=1e-4, atol=1e-7)
