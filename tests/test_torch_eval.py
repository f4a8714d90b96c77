"""The port's eval path against the JAX package's: MeshCode and its helpers,
the sprite and embedding writers, ``SNGan.eval_sampling`` on a bridged
narrow CIFAR model, ``mdl_score``'s MS-SSIM stream pairing (the CLI with
eval on is in ``test_torch_eval_cli.py``).

Tolerances: codes rtol 1e-6 (the same numpy float32); sprite pixels and
embedding files equal; generated images rtol 1e-4 / atol 1e-5 and scores
rtol 1e-4 / atol 1e-4 (float32 convolutions summed in another order); the
MS-SSIM of the real halves atol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mmdgan_tpu.metrics.scores import GenerativeModelMetric as JaxMetric
from mmdgan_tpu.models.sngan import SNGan as JaxSNGan
from mmdgan_tpu.ops import mesh_code as jax_mesh_code
from mmdgan_tpu.utils import sprite as jax_sprite
from mmdgan_torch.architectures import cifar_architecture
from mmdgan_torch.metrics.scores import GenerativeModelMetric
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.ops import mesh_code
from mmdgan_torch.utils import sprite
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(2)


# ----------------------------------------------------------------------
# MeshCode
# ----------------------------------------------------------------------
def test_mesh_code_sine_and_feature_match_jax(key):
    jmc, mc = jax_mesh_code.MeshCode(16, (5, 4)), mesh_code.MeshCode(16, (5, 4))
    z_support = np.asarray(jax.random.normal(key, (4, 16)), np.float32)
    np.testing.assert_allclose(mc.by_sine(z_support=z_support), jmc.by_sine(key=key), rtol=1e-6)
    perm = np.asarray(jax.random.permutation(key, 16))
    np.testing.assert_array_equal(mc.by_feature(perm=perm), jmc.by_feature(key=key))
    np.testing.assert_array_equal(mc.by_feature(), jmc.by_feature())
    for mode in (0, 1, 2, "random", "sine", "feature"):
        z = mc.get_batch(mode, generator=torch.Generator().manual_seed(3))
        assert z.shape == (20, 16) and z.dtype == np.float32 and np.isfinite(z).all()
        again = mc.get_batch(mode, generator=torch.Generator().manual_seed(3))
        np.testing.assert_array_equal(z, again)
    with pytest.raises(ValueError):
        mc.get_batch(7)


def test_simple_grid_kron_and_slerp_match_jax(rng):
    for got, want in zip(mesh_code.MeshCode(2, (3, 4)).simple_grid(),
                         jax_mesh_code.MeshCode(2, (3, 4)).simple_grid()):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        mesh_code.MeshCode(3).simple_grid()
    a, b = rng.randn(2, 3), rng.randn(4, 2)
    np.testing.assert_array_equal(mesh_code.kron_by_reshape(a, b),
                                  jax_mesh_code.kron_by_reshape(a, b))
    np.testing.assert_allclose(mesh_code.kron_by_reshape(a, b), np.kron(a, b), rtol=1e-12)
    p0, p1 = rng.randn(8), rng.randn(8)
    for t in (0.0, 0.3, np.linspace(0, 1, 5)):
        np.testing.assert_allclose(mesh_code.slerp(p0, p1, t), jax_mesh_code.slerp(p0, p1, t),
                                   rtol=1e-12)
    np.testing.assert_allclose(mesh_code.slerp(p0, p0 * 2, 0.5), jax_mesh_code.slerp(p0, p0 * 2,
                                                                                       0.5))


# ----------------------------------------------------------------------
# sprites and embeddings
# ----------------------------------------------------------------------
@pytest.mark.parametrize("channels,invert", [(3, False), (1, True), (4, False)])
def test_sprite_pixels_equal_jax(tmp_path, rng, channels, invert):
    imgs = rng.rand(7, 6, 5, channels).astype(np.float32) * 2 - 1
    got = sprite.write_sprite_wrapper(imgs, (2, 4), "t", str(tmp_path / "port"),
                                      file_index="_a", if_invert=invert)
    want = jax_sprite.write_sprite_wrapper(imgs, (2, 4), "t", str(tmp_path / "jax"),
                                           file_index="_a", if_invert=invert)
    assert os.path.basename(got) == os.path.basename(want) == "t_a.png"
    g, w = Image.open(got), Image.open(want)
    assert g.mode == w.mode
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_array_equal(np.asarray(g), sprite.images_to_sprite(imgs, (2, 4),
                                                                         invert).squeeze())


def test_sprite_channels_first_and_default_mesh(tmp_path, rng):
    imgs = rng.rand(5, 3, 4, 4).astype(np.float32) * 2 - 1
    got = sprite.write_sprite_wrapper(imgs, None, "t", str(tmp_path / "port"),
                                      image_format="channels_first")
    want = jax_sprite.write_sprite_wrapper(imgs, None, "t", str(tmp_path / "jax"),
                                           image_format="channels_first")
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))
    assert np.asarray(Image.open(got)).shape == (8, 12, 3)


def test_embedding_files_equal_jax(tmp_path, rng):
    emb = rng.randn(8, 4)
    imgs = rng.rand(8, 8, 8, 3).astype(np.float32) * 2 - 1
    labels = np.arange(8) % 2
    paths = {}
    for name, module in (("port", sprite), ("jax", jax_sprite)):
        paths[name] = module.embedding_image_wrapper(
            emb, "t", "scores", str(tmp_path / name), file_index="_3", labels=labels,
            images=imgs, mesh_num=(2, 4))
    for f in ("t_3_embeddings.tsv", "t_3_metadata.tsv", "projector_config.pbtxt"):
        assert (open(tmp_path / "port" / f).read() == open(tmp_path / "jax" / f).read()), f
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / "t_3_sprite.png")),
                                  np.asarray(Image.open(tmp_path / "jax" / "t_3_sprite.png")))


# ----------------------------------------------------------------------
# eval_sampling and mdl_score
# ----------------------------------------------------------------------
def narrow_cifar() -> dict:
    """cifar_architecture() at 1/8 of the hidden widths."""
    arch = cifar_architecture()
    for layer in arch["generator"][1:-1] + arch["discriminator"][:-1]:
        layer["out"] //= 8
    arch["generator"][0].update(out=64 * 4 * 4, out_reshape=[64, 4, 4])
    arch["discriminator"][-2]["out_reshape"] = [4 * 4 * 64]
    return arch


@pytest.fixture(scope="module")
def bridged():
    """The narrow CIFAR model in both packages, float32: random trees of
    JAX's shapes (BN statistics off (0, 1), so eval mode means something),
    bridged into the port."""
    arch = narrow_cifar()
    jmodel = JaxSNGan(arch, compute_dtype=jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))[:2]
    rng = np.random.RandomState(1)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("gamma", "moving_var"):
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return (0.2 * rng.randn(*leaf.shape)).astype(np.float32)

    params, state = jax.tree_util.tree_map_with_path(fill, shapes)
    model = SNGan(arch, compute_dtype=torch.float32, device="cpu")
    tparams, tstate = jax_params_to_torch(model, params, state)
    return jmodel, params, state, model, tparams, tstate


def test_eval_sampling_matches_jax(tmp_path, bridged):
    jmodel, params, state, model, tparams, tstate = bridged
    code_x = np.random.RandomState(0).randn(16, 128).astype(np.float32)
    real = np.random.RandomState(2).randint(0, 256, (16, 32, 32, 3), np.uint8)
    kw = dict(mesh_num=(4, 4), code_x=code_x, real_batch={"x": real}, get_dis_score=True,
              do_sprite=True, do_embedding=True, global_step=7)
    want = jmodel.eval_sampling(params, state, "cifar", "run", output_dir=str(tmp_path / "jax"),
                                **kw)
    got = model.eval_sampling(tparams, tstate, "cifar", "run", output_dir=str(tmp_path / "port"),
                              **kw)
    np.testing.assert_allclose(got["x_gen"], want["x_gen"], rtol=1e-4, atol=1e-5)
    for k in ("s_x", "s_gen"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    for k in ("sprite_real", "sprite_gen", "embedding"):
        assert os.path.relpath(got[k], tmp_path / "port") == os.path.relpath(want[k],
                                                                             tmp_path / "jax")
    np.testing.assert_array_equal(np.asarray(Image.open(got["sprite_real"])),
                                  np.asarray(Image.open(want["sprite_real"])))
    # generated pixels may round to the neighbouring level
    diff = np.abs(np.asarray(Image.open(got["sprite_gen"]), np.int16)
                  - np.asarray(Image.open(want["sprite_gen"]), np.int16))
    assert diff.max() <= 1 and diff.shape == (128, 128, 3)


def test_eval_sampling_draws_mesh_codes_from_a_generator(tmp_path, bridged):
    *_, model, tparams, tstate = bridged
    runs = [model.eval_sampling(tparams, tstate, "cifar", "run", mesh_num=(2, 3), mesh_mode=mode,
                                generator=torch.Generator().manual_seed(4), get_dis_score=False,
                                do_sprite=False, output_dir=str(tmp_path))
            for mode in (0, 0, 1)]
    assert runs[0]["x_gen"].shape == (6, 32, 32, 3)
    np.testing.assert_array_equal(runs[0]["x_gen"], runs[1]["x_gen"])
    assert not np.array_equal(runs[0]["x_gen"], runs[2]["x_gen"])


def _record_pairs(monkeypatch, cls):
    """Replace ``cls.ms_ssim_score`` by one that records its pairs."""
    pairs = []

    def record(x_batches, y_batches, num_batch=128, **kw):
        xs, ys = iter(x_batches), iter(y_batches)
        for _ in range(num_batch):
            pairs.append((np.asarray(next(xs)), np.asarray(next(ys))))
        return 0.0

    monkeypatch.setattr(cls, "ms_ssim_score", staticmethod(record))
    return pairs


def test_mdl_score_ms_ssim_pairs_halves_as_jax_does(monkeypatch, bridged):
    """Both real streams share one iterator: x takes the first halves of
    batches 0, 2, 4 and y the second halves of 1, 3, 5. Each generated
    stream restarts the generator: both halves of a pair come from one
    batch. JAX's mdl_score pairs them the same way."""
    jmodel, params, state, model, tparams, tstate = bridged
    batches = lambda: iter([{"x": np.full((4, 32, 32, 3), i, np.uint8)} for i in range(6)])
    pairs = _record_pairs(monkeypatch, GenerativeModelMetric)
    model.mdl_score(tparams, tstate, batches(), batch_size=4, num_batch=3, model="ms_ssim",
                    generator=torch.Generator().manual_seed(5))
    jpairs = _record_pairs(monkeypatch, JaxMetric)
    jmodel.mdl_score(params, state, batches(), batch_size=4, num_batch=3, model="ms_ssim",
                     key=jax.random.PRNGKey(5))
    for got in (pairs, jpairs):
        real, gen = got[:3], got[3:]
        assert [(x.shape[0], y.shape[0]) for x, y in real] == [(2, 2)] * 3
        assert [(x[0, 0, 0, 0], y[0, 0, 0, 0]) for x, y in real] == [
            (np.float32(i / 127.5 - 1.0), np.float32((i + 1) / 127.5 - 1.0)) for i in (0, 2, 4)]
        assert not any(np.array_equal(x, y) for x, y in gen)
    g = torch.Generator().manual_seed(5)
    for x, y in pairs[3:]:   # the port's generated pairs: one batch each
        batch = model.generate(tparams, tstate, g, 4).numpy()
        np.testing.assert_array_equal(np.concatenate([x, y]), batch)


def test_mdl_score_ms_ssim_of_the_data_matches_jax(bridged):
    jmodel, params, state, model, tparams, tstate = bridged
    data = np.random.RandomState(3).randint(0, 256, (4, 8, 32, 32, 3), np.uint8)
    got = model.mdl_score(tparams, tstate, iter(list(data)), batch_size=8, num_batch=2,
                          model="ms_ssim", generator=torch.Generator().manual_seed(0))
    want = jmodel.mdl_score(params, state, iter(list(data)), batch_size=8, num_batch=2,
                            model="ms_ssim")
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    assert np.isfinite(got[1])


def test_mdl_score_v1_with_a_given_classifier(bridged):
    """IS/FID with the time of each part; uint8 and float batches alike."""
    from mmdgan_torch.metrics.inception import RandomFeatureClassifier

    *_, model, tparams, tstate = bridged
    rng = np.random.RandomState(0)
    data = [rng.randint(0, 256, (16, 32, 32, 3), np.uint8) for _ in range(2)]
    data += [(d.astype(np.float32) / 127.5 - 1.0) for d in data]
    seconds = {}
    clf = RandomFeatureClassifier(pool_dim=16, num_logits=10, device="cpu")
    scores = model.mdl_score(tparams, tstate, iter(data), batch_size=16, num_batch=4,
                             classifier=clf, seconds=seconds,
                             generator=torch.Generator().manual_seed(1))
    assert len(scores) == 4 and np.isfinite(scores).all()
    assert set(seconds) == {"data", "generation", "classifier", "fid"}
