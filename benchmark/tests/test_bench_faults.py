"""Whole runs of the fixture's cells on the CPU (the harness without its
look for a card), sound and with the timed path broken underneath: a
sound run comes out correct; a step that returns its state unchanged,
half of the batch left out (the mean over the rest), kernel means that
are wrong or left half done where they are produced, an answer altered
where it is produced, or the reference in float8 in the program's place,
each comes out not correct."""

import numpy as np
import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.helpers import FIXTURES, SEED, fixture_spec, run_fixture


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve", "tiny.train-records"])
def test_a_sound_run_is_correct(cell):
    res = run_fixture(cell)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    assert set(res["compared"]) == set(harness.load_cell(fixture_spec(), cell,
                                                         FIXTURES)["limits"])


def _unchanged_state(monkeypatch):
    import mmdgan_torch.train.step as step

    monkeypatch.setattr(step, "_update", lambda *a, **k: None)
    monkeypatch.setattr(step, "_set_net_state", lambda *a, **k: None)


def _unchanged_window(monkeypatch):
    """Only the K-step window leaves the state as it found it."""
    import mmdgan_torch.train.step as step

    window = step._window

    def unchanged(step_fn, ts, num_steps, *a, **k):
        if num_steps == 1:
            return window(step_fn, ts, num_steps, *a, **k)
        before = [t.clone() for t in ts.tensors()]
        out = window(step_fn, ts, num_steps, *a, **k)
        with torch.no_grad():
            for t, b in zip(ts.tensors(), before):
                t.copy_(b)
        return out

    monkeypatch.setattr(step, "_window", unchanged)


def _half_batch(monkeypatch):
    from mmdgan_torch.ops.losses import GANLoss

    apply = GANLoss.apply

    def half(self, s_gen, s_x, loss_type="logistic", batch_size=None, **kw):
        h = s_gen.shape[0] // 2
        return apply(self, s_gen[:h], s_x[:h], loss_type, batch_size=h, **kw)

    monkeypatch.setattr(GANLoss, "apply", half)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.train-records"])
@pytest.mark.parametrize("fault", [_unchanged_state, _unchanged_window, _half_batch])
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run_fixture(cell)["correct"]


def _means_off(means, s_gen, s_x, sigma):
    return 1.0 - 1.5 * (1.0 - means(s_gen, s_x, sigma))


def _means_half_done(means, s_gen, s_x, sigma):
    h = s_gen.shape[0] // 2
    return means(s_gen[:h], s_x[:h], sigma)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.train-records"])
@pytest.mark.parametrize("alter", [_means_off, _means_half_done])
def test_broken_kernel_means_are_not_correct(cell, alter, monkeypatch):
    """The forward kernel's means reach the losses alone: the backward is
    built from the saved scores, so only the compared means see them."""
    from mmdgan_torch.ops import cuda_mmd

    means = cuda_mmd.kernel_means_reference
    monkeypatch.setattr(cuda_mmd, "kernel_means_reference",
                        lambda s_gen, s_x, sigma=1.0: alter(means, s_gen, s_x, sigma))
    res = run_fixture(cell)
    means1 = res["compared"]["means1_gap"]
    assert means1["value"] > means1["limit"] and not res["correct"]


def test_an_altered_record_is_not_correct(monkeypatch):
    from mmdgan_torch.data.pipeline import ReadTFRecords

    shape = ReadTFRecords._shape_x

    def altered(self, x):
        x = shape(self, x).copy()
        x[0, 0, 0] ^= 1
        return x

    monkeypatch.setattr(ReadTFRecords, "_shape_x", altered)
    res = run_fixture("tiny.train-records")
    assert res["compared"]["reader_misses"]["value"] > 0 and not res["correct"]


def _served(monkeypatch, alter):
    import mmdgan_torch.utils.export as export

    load = export.load_exported

    def broken(path, device=None):
        fn = load(path, device=device)
        return lambda z: alter(fn(z).clone())

    monkeypatch.setattr(export, "load_exported", broken)


def _altered_answer(out):
    out[0, 0, 0, 0] += 0.5
    return out


def _half_rows(out):
    out[out.shape[0] // 2:] = 0.0
    return out


@pytest.mark.parametrize("alter", [_altered_answer, _half_rows])
def test_a_broken_server_is_not_correct(alter, monkeypatch):
    _served(monkeypatch, alter)
    assert not run_fixture("tiny.serve")["correct"]


def _fails(readings, limits):
    return any(name in limits and value > limits[name] for name, value in readings.items())


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
def test_the_control_is_not_correct(cell):
    c = harness.load_cell(fixture_spec(), cell, FIXTURES)
    kind = c["mix"]["kind"]
    out = (calibrate.train_control if kind == "device_train" else calibrate.serve_control)(
        c, SEED, "cpu")
    assert _fails(out["control"], c["limits"]), out["control"]
    for fault, readings in out.items():
        assert _fails(readings, c["limits"]), (fault, readings)


def test_seeds_make_the_same_inputs():
    from benchmark.drivers import _port

    assert _port.seeds(SEED) == _port.seeds(SEED) != _port.seeds(SEED + 1)
    a = _port.make_images([4, 8, 8, 3], 5, torch.device("cpu"))
    np.testing.assert_array_equal(a, _port.make_images([4, 8, 8, 3], 5, torch.device("cpu")))
