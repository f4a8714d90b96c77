"""The port's TF1 checkpoint import (``utils/tf_bundle.py``,
``utils/tf1_import.py``) against TensorFlow's reader and the JAX package's
``import_reference_checkpoint``.

- A bundle written here by TF (``tf.compat.v1.train.Saver``) reads to the
  arrays ``tf.train.load_checkpoint`` gives, bitwise; a flipped byte of a
  tensor raises on its crc32c.
- Reference-named variables (the scoping of ``tf1_import.py``'s docstring,
  seeded random values in the reference's layout) go through both
  importers; the port's generator and discriminator outputs match JAX's at
  rtol 1e-5 / atol 1e-6 (float32; the two frameworks sum in different
  orders), for NCHW and NHWC checkpoints, plain, residual/non-local and
  conditional layers.
- ``tests/data/tf1_narrow/`` holds a narrow NCHW bundle written by TF and
  JAX's outputs on it, which ``chip_smoke.py`` phase 15e loads on the card;
  ``python tests/test_torch_tf1_import.py`` rewrites it, and a test holds
  the committed files to a fresh write.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mmdgan_tpu.models.sngan import SNGan as JaxSNGan  # noqa: E402
from mmdgan_tpu.utils.tf1_import import import_reference_checkpoint as jax_import  # noqa: E402
from mmdgan_torch.models.sngan import SNGan  # noqa: E402
from mmdgan_torch.train.state import tree_leaves  # noqa: E402
from mmdgan_torch.utils.tf1_import import _NAMES, import_reference_checkpoint  # noqa: E402
from mmdgan_torch.utils.tf_bundle import TFBundle  # noqa: E402

torch.set_num_threads(1)
FIXTURE = os.path.join(REPO, "tests", "data", "tf1_narrow")
TOL = dict(rtol=1e-5, atol=1e-6)
C = 3   # classes of the conditional architectures

# the fixture's model: the CIFAR layer kinds, narrow, 16x16 (a few tens of kB)
NARROW = {
    "input": [[3, 16, 16]],
    "code": [[8, "linear"]],
    "generator": [
        {"name": "l1", "out": 8 * 4 * 4, "op": "d", "act": "linear", "act_nm": None,
         "out_reshape": [8, 4, 4]},
        {"name": "l2_up", "out": 8, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l3_up", "out": 4, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l4_t", "out": 3, "act": "tanh"},
    ],
    "discriminator": [
        {"name": "l1", "out": 8, "act": "lrelu", "act_k": 1.3, "w_nm": "s"},
        {"name": "l2_ds", "out": 8, "act": "lrelu", "act_k": 1.3, "w_nm": "s",
         "kernel": 4, "strides": 2},
        {"name": "l3_ds", "out": 8, "act": "lrelu", "act_k": 1.3, "w_nm": "s",
         "kernel": 4, "strides": 2, "out_reshape": [4 * 4 * 8]},
        {"name": "l4_s", "out": 8, "op": "d", "act_k": 1.3, "bias": "b", "w_nm": "s"},
    ],
}

RESNL = {   # a residual G block with bilinear upsampling, a pooled non-local D block
    "input": [(2, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 4 * 4 * 4, "op": "d", "act": "linear", "act_nm": None,
         "out_reshape": [4, 4, 4]},
        {"name": "l2", "type": "res", "out": 8, "act": "relu", "act_nm": "bn",
         "kernel": [3, 3, 1], "strides": 1, "scale": ["bil", 2]},
        {"name": "l3", "out": 2, "op": "c", "act": "tanh", "kernel": 3, "strides": 1},
    ],
    "discriminator": [
        {"name": "l1", "out": 8, "op": "c", "act": "lrelu", "act_k": 1.3, "w_nm": "s",
         "kernel": 3, "strides": 2},
        {"name": "l2", "type": "nl_pool", "op": "c", "out": [2, 2, 8], "kernel": [1, 1, 1],
         "act": "linear", "w_nm": None, "act_nm": "bn", "out_reshape": [4 * 4 * 8]},
        {"name": "l3", "out": 4, "op": "d", "w_nm": "s", "act_k": 1.0},
    ],
}

COND = {   # every conditional op: cbn on a dense trunk, tcck, bcb, cck, c_bias, dcd, project
    "input": [(2, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 4 * 4, "op": "d", "act": "relu", "act_nm": "cbn",
         "out_reshape": [8, 4, 4]},
        {"name": "l2", "out": 4, "op": "tcck", "act": "relu", "act_nm": "cbn",
         "kernel": 4, "strides": 2, "w_nm": "s"},
        {"name": "l3", "out": 2, "act": "tanh", "bias": "bcb"},
    ],
    "discriminator": [
        {"name": "l1", "out": 8, "op": "cck", "act": "lrelu", "act_k": 1.3, "w_nm": "s",
         "kernel": 4, "strides": 2, "bias": "c_bias", "out_reshape": [4 * 4 * 8]},
        {"name": "l2", "out": 6, "op": "dcd", "act": "lrelu", "w_nm": "s", "bias": "bcb"},
        {"name": "l3", "out": 1, "op": "d", "w_nm": "s", "type": "project"},
    ],
}

DCK = {   # a dcd trunk before an image reshape, a sc op, the dck head
    "input": [(1, 8, 8)],
    "code": [(16, "linear")],
    "generator": [
        {"name": "l1", "out": 8 * 4 * 4, "op": "dcd", "act": "linear", "act_nm": None,
         "out_reshape": [8, 4, 4]},
        {"name": "l2", "out": 4, "op": "tc", "act": "relu", "act_nm": "bn",
         "kernel": 4, "strides": 2},
        {"name": "l3", "out": 1, "act": "tanh"},
    ],
    "discriminator": [
        {"name": "l1", "out": 8, "op": "sc", "act": "lrelu", "act_k": 1.3, "kernel": 3,
         "strides": 2},
        {"name": "l2", "out": 8, "op": "cck", "act": "lrelu", "w_nm": "s", "kernel": 3,
         "out_reshape": [4 * 4 * 8]},
        {"name": "l3", "out": 4, "op": "dck", "w_nm": "s"},
    ],
}
# JAX's importer cannot read an NCHW cbn over dense features (its [C, F]
# scale meets a 4-D transpose: ROADMAP C9); NCHW runs COND with that layer's
# cbn dropped, and the NCHW cbn over dense features is checked on its own
COND_CONV = {**COND, "generator": [{**COND["generator"][0], "act_nm": None}]
             + COND["generator"][1:]}
ARCHS = {"narrow": (NARROW, 0), "resnl": (RESNL, 0), "cond": (COND, C), "dck": (DCK, C)}


def _ref_layout(op, name, a, nhwc):
    """An array of the port's layout in the reference's: conv kernels back
    to HWIO (``[k, k, out, in]`` for a transposed conv), and under NHWC the
    per-class tables and power vectors channels-last."""
    kind = op.design["op"]
    if (name == "kernel" and kind in ("c", "cck", "tc", "tcck")) or name == "pointwise_kernel":
        return a.transpose(2, 3, 1, 0)
    if name == "depthwise_kernel":
        return a.transpose(2, 3, 0, 1)
    if nhwc and a.ndim == 4:
        return a.transpose(0, 2, 3, 1)
    return a


def reference_variables(model, data_format, seed):
    """Seeded random values for every variable the reference would hold for
    ``model``, by the reference's names, shaped as the reference stores
    them (a layer's flat features in the order of ``data_format``, which
    the values being random makes moot)."""
    rng = np.random.RandomState(seed)
    params, state, _ = model.init(0)
    nhwc = data_format == "NHWC"
    out = {}
    for net, routine in (("gen", model.Gen), ("dis", model.Dis)):
        for i in routine.layer_indices:
            layer = routine.net.layers[i]
            for op_name, op in layer.ops.items():
                if not hasattr(op, "design"):
                    continue
                base = f"{layer.layer_scope}/{op_name}"
                leaves = {**params[net].get(layer.layer_scope, {}).get(op_name, {}),
                          **state[net].get(layer.layer_scope, {}).get(op_name, {})}
                for name, t in leaves.items():
                    a = _ref_layout(op, name, t.detach().numpy(), nhwc)
                    fan = max(int(np.prod(a.shape[:-1])), 1) if "kernel" in name else 1
                    v = rng.randn(*a.shape) / np.sqrt(fan) * (1.0 if fan > 1 else 0.3)
                    if name == "moving_var":
                        v = rng.uniform(0.5, 1.5, a.shape)
                    src = f"{base}/SN/in_rand" if name == "sn_x" else f"{base}/{_NAMES[name]}"
                    out[src] = v.astype(np.float32)
    return out


def _dcd_repaired(jmodel, jparams, variables):
    """JAX's import with each NCHW ``dcd`` op's per-class kernels permuted
    as JAX permutes the op's own kernel: its importer takes the [C, in, out]
    ``c_kernel`` as it is, which leaves a dcd next to a flatten or an image
    reshape in the reference's C-major feature order (ROADMAP C9)."""
    from mmdgan_tpu.utils.tf1_import import TF1CheckpointImporter as JaxImporter

    out = {net: dict(tree) for net, tree in jparams.items()}
    for net, routine in (("gen", jmodel.Gen), ("dis", jmodel.Dis)):
        imp = JaxImporter(routine, "NCHW")
        layers = [routine.net.layers[i] for i in routine.layer_indices]
        for li, layer in enumerate(layers):
            for op_name, op in layer.ops.items():
                if getattr(op, "design", {}).get("op") != "dcd":
                    continue
                name = f"{layer.layer_scope}/{op_name}/c_kernel"
                ck = variables[name]
                per_class = [imp._dense_kernel({name: ck[c]}, name, layer,
                                               layers[li - 1] if li > 0 else None)
                             for c in range(ck.shape[0])]
                scope = dict(out[net][layer.layer_scope])
                scope[op_name] = {**scope[op_name], "c_kernel": jnp.asarray(np.stack(per_class))}
                out[net][layer.layer_scope] = scope
    return out


def both_outputs(arch, num_class, variables, data_format):
    """(port, JAX) of: G's images, D's eval and train scores on fixed inputs,
    each model holding the imported variables."""
    model = SNGan(arch, num_class=num_class, compute_dtype=torch.float32, device="cpu")
    params, state, _ = model.init(0)
    params, state = import_reference_checkpoint(model, params, state, variables, data_format)
    jmodel = JaxSNGan(arch, num_class=num_class, compute_dtype=jnp.float32)
    jparams, jstate, _ = jmodel.init(jax.random.PRNGKey(0))
    jparams, jstate = jax_import(jmodel, jparams, jstate, variables, data_format)
    if data_format == "NCHW":
        jparams = _dcd_repaired(jmodel, jparams, variables)

    c, h, w = arch["input"][0]
    rng = np.random.RandomState(1)
    z = rng.randn(4, model.code_size).astype(np.float32)
    y = None if num_class < 2 else rng.randint(0, num_class, (4, 1)).astype(np.int32)
    x = rng.randn(4, h, w, c).clip(-1, 1).astype(np.float32)
    jy = None if y is None else jnp.asarray(y)
    got = [model.generate(params, state, code_batch={"x": z, "y": y}, clip=False).numpy()]
    want = [np.asarray(jmodel.generate(jparams, jstate, code_batch={"x": jnp.asarray(z), "y": jy},
                                       clip=False))]
    for train in (False, True):
        got.append(model.discriminate(params, state, {"x": x, "y": y},
                                      train=train).detach().numpy())
        want.append(np.asarray(jmodel.discriminate(jparams, jstate,
                                                   {"x": jnp.asarray(x), "y": jy}, train=train)))
    return got, want, (z, y, x)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_import_matches_jax(arch, data_format):
    design, num_class = ARCHS[arch]
    if arch == "cond" and data_format == "NCHW":
        design = COND_CONV
    model = SNGan(design, num_class=num_class, compute_dtype=torch.float32, device="cpu")
    variables = reference_variables(model, data_format, seed=7)
    got, want, _ = both_outputs(design, num_class, variables, data_format)
    for what, g, w in zip(("generate", "discriminate eval", "discriminate train"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"{arch} {data_format} {what}")


def test_nchw_cbn_over_dense_features():
    """An NCHW checkpoint's cbn over a dense layer's flat features keeps its
    [C, F] tables as they are (the reference's C-major order is the
    port's); JAX's importer raises on them (ROADMAP C9)."""
    model = SNGan(COND, num_class=C, compute_dtype=torch.float32, device="cpu")
    params, state, _ = model.init(0)
    variables = reference_variables(model, "NCHW", seed=5)
    new_p, _ = import_reference_checkpoint(model, params, state, variables)
    for name in ("scale", "offset"):
        np.testing.assert_array_equal(new_p["gen"]["gen/l1"]["BN"][name].numpy(),
                                      variables[f"gen/l1/BN/{name}"])
    jmodel = JaxSNGan(COND, num_class=C, compute_dtype=jnp.float32)
    jparams, jstate, _ = jmodel.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="axes don't match"):
        jax_import(jmodel, jparams, jstate, variables, "NCHW")


def test_import_fills_every_leaf_and_checks_shapes():
    """Every parameter and state leaf of the narrow model comes from the
    checkpoint; a missing variable and a misshapen one raise."""
    model = SNGan(NARROW, compute_dtype=torch.float32, device="cpu")
    params, state, _ = model.init(0)
    variables = reference_variables(model, "NCHW", seed=3)
    new_p, new_s = import_reference_checkpoint(model, params, state, variables)
    want = {round(float(np.abs(v).sum()), 3) for v in variables.values()}
    got = {round(float(t.abs().sum()), 3) for t in tree_leaves(new_p) + tree_leaves(new_s)}
    assert got == want
    missing = dict(variables)
    missing.pop("gen/l2_up/kernel/kernel")
    with pytest.raises(KeyError, match="gen/l2_up/kernel/kernel"):
        import_reference_checkpoint(model, params, state, missing)
    bad = dict(variables)
    bad["dis/l4_s/kernel/kernel"] = bad["dis/l4_s/kernel/kernel"][:-1]
    with pytest.raises(ValueError, match="dis/l4_s/kernel/kernel"):
        import_reference_checkpoint(model, params, state, bad)


def _save_bundle(variables, prefix):
    """Write ``variables`` as TF1 variables through ``tf.compat.v1.train.Saver``
    in a subprocess (TF's graph mode stays out of this process); returns
    the prefix."""
    npz = prefix + ".npz"
    np.savez(npz, **{k.replace("/", "|"): v for k, v in variables.items()})
    code = (
        "import sys, numpy as np, tensorflow as tf\n"
        "tf.compat.v1.disable_eager_execution()\n"
        "d = np.load(sys.argv[1])\n"
        "g = tf.Graph()\n"
        "with g.as_default():\n"
        "    for k in sorted(d.files):\n"
        "        tf.compat.v1.Variable(d[k], name=k.replace('|', '/'))\n"
        "    saver = tf.compat.v1.train.Saver()\n"
        "    with tf.compat.v1.Session() as s:\n"
        "        s.run(tf.compat.v1.global_variables_initializer())\n"
        "        saver.save(s, sys.argv[2], write_meta_graph=False)\n")
    env = dict(os.environ, TF_CPP_MIN_LOG_LEVEL="3", CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-c", code, npz, prefix], check=True, env=env,
                   capture_output=True, timeout=300)
    os.remove(npz)
    return prefix


def test_bundle_reads_like_tensorflow_and_checks_crc(tmp_path):
    """A TF-written bundle of several dtypes and shapes reads bitwise as
    ``tf.train.load_checkpoint`` reads it; a flipped byte raises."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.RandomState(0)
    variables = {"gen/l1/kernel/kernel": rng.randn(16, 32).astype(np.float32),
                 "dis/l1/bias/bias": rng.randn(7).astype(np.float32),
                 "x/scalar": np.float32(2.5), "x/f64": rng.randn(2, 3),
                 "x/i32": rng.randint(-5, 5, (3, 4)).astype(np.int32),
                 "x/i64": rng.randint(-5, 5, (5,)).astype(np.int64),
                 "x/f16": rng.randn(4).astype(np.float16)}
    prefix = _save_bundle(variables, str(tmp_path / "model.ckpt"))
    reader = tf.train.load_checkpoint(prefix)
    bundle = TFBundle(prefix)
    assert bundle.shape_map() == {k: tuple(v) for k, v in
                                  reader.get_variable_to_shape_map().items()}
    for name in reader.get_variable_to_shape_map():
        want = reader.get_tensor(name)
        got = bundle.get_tensor(name)
        assert got.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert TFBundle(str(tmp_path)).prefix == prefix   # through the checkpoint file

    entry = bundle.entries["gen/l1/kernel/kernel"]
    data = prefix + ".data-00000-of-00001"
    raw = bytearray(open(data, "rb").read())
    raw[entry.offset + 5] ^= 0x40
    open(data, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        TFBundle(prefix).get_tensor("gen/l1/kernel/kernel")
    TFBundle(prefix).get_tensor("dis/l1/bias/bias")   # the others still read


def test_compressed_block_raises(tmp_path):
    prefix = _save_bundle({"a/b": np.ones(3, np.float32)}, str(tmp_path / "m"))
    index = prefix + ".index"
    raw = bytearray(open(index, "rb").read())
    # the first data block starts at 0; its trailer's type byte follows it
    footer = raw[-48:]
    from mmdgan_torch.utils.tf_bundle import _entries, _handle

    _, pos = _handle(bytes(footer), 0)
    (off, size), _ = _handle(bytes(footer), pos)
    block = bytes(raw[off:off + size])
    (data_off, data_size), _ = _handle(next(_entries(block))[1], 0)
    raw[data_off + data_size] = 1   # snappy
    open(index, "wb").write(bytes(raw))
    with pytest.raises(NotImplementedError, match="compressed"):
        TFBundle(prefix)


def write_fixture(folder):
    """The narrow NCHW bundle (TF-written), its architecture, and JAX's
    outputs on it at fixed inputs."""
    os.makedirs(folder, exist_ok=True)
    model = SNGan(NARROW, compute_dtype=torch.float32, device="cpu")
    variables = reference_variables(model, "NCHW", seed=10)
    _save_bundle(variables, os.path.join(folder, "model.ckpt"))
    os.remove(os.path.join(folder, "checkpoint"))   # it names the writer's absolute path
    _, want, (z, _, x) = both_outputs(NARROW, 0, variables, "NCHW")
    np.savez(os.path.join(folder, "jax_outputs.npz"), z=z, x=x, gen=want[0],
             dis_eval=want[1], dis_train=want[2])
    with open(os.path.join(folder, "architecture.json"), "w") as f:
        json.dump(NARROW, f, indent=1)


def test_committed_fixture_is_current(tmp_path):
    """The committed bundle holds what a fresh write holds, JAX's committed
    outputs are JAX's outputs on it, and the port matches them from the
    committed files alone (the phase-15e check, on the CPU)."""
    write_fixture(str(tmp_path))
    fresh, committed = TFBundle(str(tmp_path / "model.ckpt")), TFBundle(
        os.path.join(FIXTURE, "model.ckpt"))
    assert fresh.names() == committed.names()
    for name in fresh.names():
        np.testing.assert_array_equal(fresh.get_tensor(name), committed.get_tensor(name))
    want, got = np.load(tmp_path / "jax_outputs.npz"), np.load(
        os.path.join(FIXTURE, "jax_outputs.npz"))
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    with open(os.path.join(FIXTURE, "architecture.json")) as f:
        assert json.load(f) == NARROW

    model = SNGan(NARROW, compute_dtype=torch.float32, device="cpu")
    params, state, _ = model.init(0)
    params, state = import_reference_checkpoint(model, params, state,
                                                os.path.join(FIXTURE, "model.ckpt"))
    np.testing.assert_allclose(
        model.generate(params, state, code_batch={"x": got["z"]}, clip=False).numpy(),
        got["gen"], **TOL)
    np.testing.assert_allclose(model.discriminate(params, state, got["x"]).numpy(),
                               got["dis_eval"], **TOL)


if __name__ == "__main__":
    shutil.rmtree(FIXTURE, ignore_errors=True)
    write_fixture(FIXTURE)
    print(f"wrote {FIXTURE}: {sorted(os.listdir(FIXTURE))}")
