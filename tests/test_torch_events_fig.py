"""The port's run-record readers (``utils/events.py``) against the JAX
package's on the same files, and ``utils/fig.py``'s plots.

``read_metrics_jsonl``: equal arrays (NaN where a record lacks a key).
``read_event_file``: the port parses TensorBoard files itself; JAX's reads
them through TensorFlow; both give the same [[step, value], ...] arrays
(bitwise: the same float32 values widened to float64). The files come from
the port's ``MetricWriter`` (torch's SummaryWriter, scalars as
``simple_value``) and from TF's writer (scalars as 0-d tensors), with
histograms and images beside the scalars.
"""

import os

import numpy as np
import pytest

from mmdgan_tpu.utils import events as jax_events
from mmdgan_torch.utils import events
from mmdgan_torch.utils.fig import Fig
from mmdgan_torch.utils.summary import MetricWriter


def _assert_series_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_run(folder, histograms=True):
    w = MetricWriter(folder)
    rng = np.random.RandomState(0)
    for step in range(0, 50, 7):
        w.scalars(step, {"loss_gen": rng.randn(), "loss_dis": rng.randn(),
                         "eval/fid": 10.0 + step})
        if histograms:
            w.raw_histogram(step, "hist/scores", np.random.RandomState(step).randn(100))
    w.scalars(60, {"only_here": 1.25})
    w.images(60, "samples", rng.uniform(-1, 1, (4, 8, 8, 3)))
    w.close()


def test_metrics_jsonl_matches_jax(tmp_path):
    _port_run(str(tmp_path), histograms=False)
    for keys in (None, ["loss_gen", "only_here"]):
        got = events.read_metrics_jsonl(str(tmp_path), keys)
        want = jax_events.read_metrics_jsonl(str(tmp_path), keys)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.isnan(events.read_metrics_jsonl(str(tmp_path))["only_here"][0])
    # histogram records are skipped; JAX's reader raises on them (ROADMAP C10)
    hist = tmp_path / "hist"
    _port_run(str(hist))
    got = events.read_metrics_jsonl(str(hist))
    np.testing.assert_array_equal(got["loss_gen"],
                                  events.read_metrics_jsonl(str(tmp_path))["loss_gen"])
    assert "counts" not in got and "hist" not in got
    with pytest.raises(ValueError):
        jax_events.read_metrics_jsonl(str(hist))
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "metrics.jsonl").write_text("")
    assert events.read_metrics_jsonl(str(empty)) == jax_events.read_metrics_jsonl(str(empty))


@pytest.mark.parametrize("tags", [None, ["loss_dis", "eval/fid"]])
def test_event_file_of_the_port_writer_matches_jax(tmp_path, tags):
    pytest.importorskip("torch.utils.tensorboard")
    _port_run(str(tmp_path))
    assert any(f.startswith("events.out.tfevents.") for f in os.listdir(tmp_path))
    got = events.read_event_file(str(tmp_path), tags)
    _assert_series_equal(got, jax_events.read_event_file(str(tmp_path), tags))
    assert got["eval/fid"][:, 1].tolist() == [10.0 + s for s in range(0, 50, 7)]


def test_event_file_of_tf_summaries_matches_jax(tmp_path):
    """TF2's writer stores scalars as 0-d float tensors; a histogram and a
    text summary beside them are skipped by both readers."""
    tf = pytest.importorskip("tensorflow")
    writer = tf.summary.create_file_writer(str(tmp_path))
    with writer.as_default():
        for step in range(5):
            tf.summary.scalar("a", 0.5 * step, step=step)
            tf.summary.scalar("b/c", -float(step) ** 2, step=step)
            tf.summary.histogram("h", np.arange(10.0) * step, step=step)
        tf.summary.text("note", "hello", step=0)
    writer.close()
    path = os.path.join(str(tmp_path), os.listdir(tmp_path)[0])
    got = events.read_event_file(path)
    _assert_series_equal(got, jax_events.read_event_file(path))
    assert sorted(got) == ["a", "b/c"]
    np.testing.assert_array_equal(got["a"], [[s, 0.5 * s] for s in range(5)])


def test_event_folder_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        events.read_event_file(str(tmp_path))


def test_fig_writes_each_plot_kind(tmp_path):
    pytest.importorskip("matplotlib")
    fig = Fig(fig_folder=str(tmp_path))
    rng = np.random.RandomState(0)
    x = rng.randn(200, 2)
    paths = [fig.hist(x[:, 0], filename="hist", xlabel="x", title="t"),
             fig.hist2d(x, filename="hist2d"),
             fig.hist2d(x[:, 0], x[:, 1], bins=10, filename="hist2d_xy"),
             fig.scatter(x, labels=np.arange(200) % 3, filename="scatter"),
             fig.scatter(x[:, 0], x[:, 1], filename="scatter_xy"),
             fig.contour(lambda p: (p ** 2).sum(1), num=20, filename="contour"),
             fig.text_scatter(x[:20], [str(i) for i in range(20)], filename="text")]
    for path in paths:
        assert path.endswith(".png") and os.path.getsize(path) > 1000
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    drawn = fig.scatter(x)   # no filename: the figure comes back
    assert hasattr(drawn, "savefig")
