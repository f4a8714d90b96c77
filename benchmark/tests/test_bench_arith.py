"""The yardstick's arithmetic against hand counts: the kernel bounds at the
main path's (B, d) = (64, 16), as PERF.md records them, and the model
FLOPs of each configuration worked layer by layer."""

import os

import pytest

from benchmark import arith, harness


def cfg(name):
    return harness.load_json(os.path.join(harness.BENCH_DIR, "configs", name + ".json"))


def test_kernel_bounds_at_the_main_path():
    # the recorded bounds have three digits
    ms, kind, pipe = arith.kernel_means_bound_ms(64, 16)
    assert ms == pytest.approx(4.67e-6, rel=5e-3) and (kind, pipe) == ("operations", "fp32")
    ms, kind, pipe = arith.kernel_means_backward_bound_ms(64, 16)
    assert ms == pytest.approx(1.24e-5, rel=5e-3) and (kind, pipe) == ("operations", "fp32")
    # by hand: 2016 + 4096 + 2016 entries; (2d + 5) flops each, 2 more on the
    # 4032 symmetric ones, 4Bd for the norms
    entries = 2016 * 2 + 4096
    assert arith.kernel_means_bound_ms(64, 16)[0] == pytest.approx(
        (entries * 37 + 4032 * 2 + 4 * 64 * 16) / 67e12 * 1e3)


# multiply-adds per image: conv = out * in * k * k * H_out * W_out; a
# transposed conv scatters each input pixel, in * out * k * k * H_in * W_in
CIFAR_D = [64 * 3 * 9 * 32 * 32, 128 * 64 * 16 * 16 * 16, 128 * 128 * 9 * 16 * 16,
           256 * 128 * 16 * 8 * 8, 256 * 256 * 9 * 8 * 8, 512 * 256 * 16 * 4 * 4,
           512 * 512 * 9 * 4 * 4, 8192 * 16]
CIFAR_G = [128 * 8192, 512 * 256 * 16 * 4 * 4, 256 * 128 * 16 * 8 * 8,
           128 * 64 * 16 * 16 * 16, 64 * 3 * 9 * 32 * 32]
CELEBA_D = [64 * 3 * 9 * 64 * 64, 128 * 64 * 16 * 32 * 32, 128 * 128 * 9 * 32 * 32,
            256 * 128 * 16 * 16 * 16, 256 * 256 * 9 * 16 * 16, 512 * 256 * 16 * 8 * 8,
            512 * 512 * 9 * 8 * 8, 1024 * 512 * 16 * 4 * 4, 1024 * 1024 * 9 * 4 * 4,
            16384 * 16]
CELEBA_G = [128 * 16384, 1024 * 512 * 16 * 4 * 4, 512 * 256 * 16 * 8 * 8,
            256 * 128 * 16 * 16 * 16, 128 * 64 * 16 * 32 * 32, 64 * 3 * 9 * 64 * 64]


@pytest.mark.parametrize("name,dis,gen", [("cifar10", CIFAR_D, CIFAR_G),
                                          ("celeba64", CELEBA_D, CELEBA_G)])
def test_layer_macs_by_hand(name, dis, gen):
    c = cfg(name)
    assert arith.layer_macs(c["architecture"], "dis") == dis
    assert arith.layer_macs(c["architecture"], "gen") == gen


def test_per_image_flops():
    assert 2 * sum(CIFAR_D) == 431_620_096 and 2 * sum(CIFAR_G) == 206_962_688
    assert 2 * sum(CELEBA_D) == 2_296_381_440 and 2 * sum(CELEBA_G) == 1_092_091_904


@pytest.mark.parametrize("name,dis,gen", [("cifar10", CIFAR_D, CIFAR_G),
                                          ("celeba64", CELEBA_D, CELEBA_G)])
def test_train_step_flops(name, dis, gen):
    b = 64
    parts = arith.train_step_flops(cfg(name))
    assert parts["gen_forward"] == 2 * b * sum(gen)
    assert parts["dis_forward"] == 2 * 2 * b * sum(dis)
    assert parts["dis_backward"] == 2 * 2 * b * (2 * sum(dis) - dis[0])
    assert parts["pull_through_dis"] == 2 * b * sum(dis)
    assert parts["gen_backward"] == 2 * b * (2 * sum(gen) - gen[0])
    assert parts["spectral_norm"] == 4 * sum(dis)
    assert parts["total"] == pytest.approx(sum(v for k, v in parts.items() if k != "total"))


def test_train_step_totals():
    assert arith.train_step_flops(cfg("cifar10"))["total"] == pytest.approx(233.38e9, rel=1e-4)
    assert arith.train_step_flops(cfg("celeba64"))["total"] == pytest.approx(1240.97e9, rel=1e-4)
