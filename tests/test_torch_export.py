"""The serving path and the restart path of the port (ROADMAP A16):
``utils/export.py`` against the JAX package's ``utils/export.py``, both
through their own artifacts, the artifact against the in-process
generator, a load with no model code, the data-parallel export at two gloo
ranks; ``utils/compilation_cache.py`` and the build directory it moves;
the serving bench and the step profiler on the CPU.

The generators are the narrow ones of JAX's export tests
(``tests/test_utils.py:112-175``), unconditional (BN) and conditional
(cbn, 4 classes), with JAX's init from ``PRNGKey(0)`` bridged over by
``jax_params_to_torch`` and BN moving statistics drawn from a seed (init
holds 0 and 1, which would hide a swapped pair). Tolerances: JAX's
artifact against the port's, rtol 1e-4 / atol 1e-5 (float32 compute on
both); the port's artifact against its in-process generator, bitwise.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdgan_tpu.models import SNGan as JaxSNGan
from mmdgan_tpu.utils.export import export_generator as jax_export_generator
from mmdgan_tpu.utils.export import load_exported as jax_load_exported
from mmdgan_torch.models.sngan import SNGan
from mmdgan_torch.ops import _build, cuda_mmd
from mmdgan_torch.tools import profile_step, serving_bench
from mmdgan_torch.utils.compilation_cache import enable_compilation_cache
from mmdgan_torch.utils.export import export_generator, load_exported
from mmdgan_torch.utils.jax_bridge import jax_params_to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 6


def same_settings_env(**extra) -> dict:
    """The environment of a child process that must compute the parent's
    bits: the parent's thread count and ATen CPU capability."""
    n = str(torch.get_num_threads())
    return dict(os.environ, OMP_NUM_THREADS=n, MKL_NUM_THREADS=n,
                ATEN_CPU_CAPABILITY=torch.backends.cpu.get_cpu_capability().lower(), **extra)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


def _arch(norm: str) -> dict:
    return {
        "input": [(1, 8, 8)], "code": [(16, "linear")],
        "generator": [
            {"name": "l1", "out": 8 * 4 * 4, "op": "d", "act": "linear",
             "act_nm": None, "out_reshape": [8, 4, 4]},
            {"name": "l2", "out": 4, "op": "tc", "act": "relu", "act_nm": norm,
             "kernel": 4, "strides": 2},
            {"name": "l3", "out": 1, "act": "tanh"},
        ],
        "discriminator": [{"name": "l1", "out": 4, "op": "d", "w_nm": "s", "in_reshape": [64]}],
    }


CASES = {"unconditional": ("bn", 0), "conditional": ("cbn", 4)}


def _models(name, compute_dtype=torch.float32):
    """(JAX model, its params and state, the port's model, params, state),
    the BN moving statistics drawn from a seed on both."""
    norm, num_class = CASES[name]
    jmodel = JaxSNGan(_arch(norm), num_class=num_class, loss_type="rep",
                      compute_dtype=jnp.float32)
    params, state, _ = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    bn = state["gen"]["gen/l2"]["BN"]
    for key, lo in (("moving_mean", -0.5), ("moving_var", 0.5)):
        bn[key] = np.asarray(lo + rng.rand(*np.shape(bn[key])), np.float32)
    model = SNGan(_arch(norm), num_class=num_class, loss_type="rep",
                  compute_dtype=compute_dtype, device="cpu")
    tparams, tstate = jax_params_to_torch(model, params, state)
    return jmodel, params, state, model, tparams, tstate


def _inputs(num_class):
    rng = np.random.RandomState(2)
    z = rng.randn(B, 16).astype(np.float32)
    y = rng.randint(0, num_class, (B, 1)).astype(np.int32) if num_class else None
    return z, y


@pytest.mark.parametrize("name", list(CASES))
def test_exported_generator_matches_jax_artifact(tmp_path, name):
    """JAX's artifact (``platforms=('cpu',)``, loaded by its
    ``load_exported``) and the port's (exported and loaded on the CPU)
    give the same images from the same bridged weights."""
    jmodel, params, state, model, tparams, tstate = _models(name)
    z, y = _inputs(CASES[name][1])
    jfn = jax_load_exported(jax_export_generator(jmodel, params, state, B,
                                                 str(tmp_path / "g.stablehlo"),
                                                 platforms=("cpu",)))
    want = np.asarray(jfn(z) if y is None else jfn(z, y))
    fn = load_exported(export_generator(model, tparams, tstate, B, str(tmp_path / "g.pt2"),
                                        device="cpu"), device="cpu")
    got = fn(z) if y is None else fn(z, y)
    assert got.shape == want.shape == (B, 8, 8, 1) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_loaded_artifact_equals_in_process_generation(tmp_path, name, dtype):
    """The loaded program runs the generator's own ops on the same
    weights: bitwise ``SNGan.generate``, in float32 and under bf16
    compute on the CPU."""
    _, _, _, model, params, state = _models(name, dtype)
    z, y = _inputs(CASES[name][1])
    fn = load_exported(export_generator(model, params, state, B, str(tmp_path / "g.pt2"),
                                        device="cpu"), device="cpu")
    got = fn(z) if y is None else fn(z, y)
    want = model.generate(params, state, code_batch={"x": torch.tensor(z),
                                                     "y": None if y is None else torch.tensor(y)})
    assert torch.equal(got, want)


def test_artifact_loads_without_model_code(tmp_path):
    """A process that imports torch alone loads the conditional artifact
    with ``torch.export.load`` and gives the in-process images bitwise;
    no module of the port is imported there."""
    _, _, _, model, params, state = _models("conditional")
    z, y = _inputs(4)
    path = export_generator(model, params, state, B, str(tmp_path / "g.pt2"), device="cpu")
    np.save(tmp_path / "z.npy", z)
    np.save(tmp_path / "y.npy", y)
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads({torch.get_num_threads()})
        program = torch.export.load({path!r})
        z = torch.tensor(np.load({str(tmp_path / 'z.npy')!r}))
        y = torch.tensor(np.load({str(tmp_path / 'y.npy')!r}))
        with torch.no_grad():
            out = program.module()(z, y)
        assert not [m for m in sys.modules if m.startswith("mmdgan")], sorted(sys.modules)
        np.save({str(tmp_path / 'out.npy')!r}, out.numpy())
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), capture_output=True,
                          text=True, env=same_settings_env(PYTHONPATH=""), timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = model.generate(params, state, code_batch={"x": torch.tensor(z), "y": torch.tensor(y)})
    assert np.array_equal(np.load(tmp_path / "out.npy"), want.numpy())


DP_RANK = """
import sys
import numpy as np
import torch
torch.set_num_threads({threads})
sys.path.insert(0, {repo!r})
from mmdgan_torch.parallel.mesh import DataParallel, init_distributed
from mmdgan_torch.utils.export import export_generator, load_exported
rank = int(sys.argv[1])
init_distributed("gloo", "file://{store}", rank, 2)
dp = DataParallel(device="cpu")
model, params, state = torch.load({model!r}, weights_only=False)
path = export_generator(model, params, state, {batch}, {out!r}, device="cpu", dp=dp)
z = torch.tensor(np.load({z!r}))
rows = load_exported(path, device="cpu")(dp.local_rows(z))
np.save({out!r} + f".rank{{rank}}.npy", rows.numpy())
torch.distributed.destroy_process_group()
"""


def test_data_parallel_export_at_two_gloo_ranks(tmp_path):
    """``export_generator(dp=)`` at two gloo ranks: one artifact of
    ``local_batch_size(B)`` rows, written by rank 0, which every rank
    loads; each rank's images from its rows of the global z equal the
    in-process generator's images of those rows, bitwise. The parent
    generates each rank's rows at the artifact's batch: with MKL's AVX2
    kernels (``MKL_ENABLE_INSTRUCTIONS=AVX2``) three rows and six round
    the dense layer differently, by up to 2.2e-7 in the images."""
    _, _, _, model, params, state = _models("unconditional")
    z, _ = _inputs(0)
    torch.save((model, params, state), tmp_path / "model.pt")
    np.save(tmp_path / "z.npy", z)
    script = DP_RANK.format(repo=REPO, store=tmp_path / "store", model=str(tmp_path / "model.pt"),
                            batch=B, out=str(tmp_path / "g.pt2"), z=str(tmp_path / "z.npy"),
                            threads=torch.get_num_threads())
    env = same_settings_env()
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    program = torch.export.load(str(tmp_path / "g.pt2"))
    assert program.example_inputs[0][0].shape == (B // 2, 16)
    for r in range(2):
        rows = torch.tensor(z[r * B // 2:(r + 1) * B // 2])
        want = model.generate(params, state, code_batch={"x": rows}).numpy()
        got = np.load(f"{tmp_path / 'g.pt2'}.rank{r}.npy")
        assert np.array_equal(got, want)


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """Without a GPU the export, the load, the serving bench and the
    profiler raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, model, params, state = _models("unconditional")
    path = export_generator(model, params, state, B, str(tmp_path / "g.pt2"), device="cpu")
    for call in (lambda: export_generator(model, params, state, B, str(tmp_path / "h.pt2")),
                 lambda: load_exported(path),
                 lambda: serving_bench.bench("cifar", [2]),
                 lambda: profile_step.collect("cifar", "rep", 4, 2, 1)):
        with pytest.raises(RuntimeError, match="no GPU"):
            call()


@pytest.fixture
def cache_env(monkeypatch, tmp_path):
    """The environment the cache sets, restored after the test; ``build/``
    moved to a temporary folder."""
    for name in (_build.CACHE_ENV, _build.CACHE_MIN_SECONDS_ENV, "TORCHINDUCTOR_CACHE_DIR",
                 "TRITON_CACHE_DIR"):
        monkeypatch.setenv(name, "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def _shared_library(path) -> None:
    """A real shared library (one C function) at ``path``, built with cc."""
    src = path.parent / "one.c"
    src.write_text("int mmdgan_cache_probe(void) { return 7; }\n")
    path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(path), str(src)], check=True)


def test_cached_library_loads_without_nvcc(cache_env, monkeypatch):
    """With the cache on, a library under the cache's directory, keyed by
    the source's hash, loads without nvcc (``_nvcc`` patched to raise), in
    this process and in a child process that inherits the setting."""
    cache = enable_compilation_cache(str(cache_env / "cache"))
    assert cache == str(cache_env / "cache") and os.environ["TORCHINDUCTOR_CACHE_DIR"].startswith(
        cache) and os.environ["TRITON_CACHE_DIR"].startswith(cache)
    path = _build.library_path(cuda_mmd.SOURCE)
    assert path.parent == cache_env / "cache"
    _shared_library(path)

    def no_nvcc():
        raise AssertionError("nvcc was run")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.load(cuda_mmd.SOURCE).mmdgan_cache_probe() == 7
    child = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from mmdgan_torch.ops import _build, cuda_mmd; "
         "_build._nvcc = None; print(_build.build(cuda_mmd.SOURCE))", REPO],
        capture_output=True, text=True, timeout=120)
    assert child.returncode == 0 and child.stdout.strip() == str(path), child.stderr[-2000:]


@pytest.mark.parametrize("min_seconds,where", [(0.0, "cache"), (3600.0, "build")])
def test_cache_keeps_builds_that_took_min_compile_seconds(cache_env, monkeypatch, min_seconds,
                                                          where):
    """A build is written to the cache when it took at least
    ``min_compile_seconds``, else to ``build/``; either way a second
    build of the same source runs no compiler."""
    enable_compilation_cache(str(cache_env / "cache"), min_compile_seconds=min_seconds)
    made = cache_env / "made.so"
    _shared_library(made)
    fake = cache_env / "fake_nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'cp {made} "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    out = _build.build(cuda_mmd.SOURCE)
    assert out == _build.library_path(cuda_mmd.SOURCE, cache_env / where)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/nonexistent/nvcc")
    assert _build.build(cuda_mmd.SOURCE) == out


def test_serving_bench_and_profile_step_on_the_cpu(capsys):
    """Both tools run end to end on the CPU at a small size: the serving
    bench's records (in-process and exported images/s, export and load
    seconds) and the profiler's three tables of the full-width CIFAR-10
    window (host ops on the CPU)."""
    records = serving_bench.bench("cifar", [2], device="cpu", compute_dtype=torch.float32,
                                  calls=1)
    assert [sorted(r) for r in records] == [["arch", "export_img_per_sec", "export_s",
                                             "load_s", "model_img_per_sec", "turns"]]
    assert [len(v) for v in records[0]["turns"].values()] == [2, 2]
    assert records[0]["model_img_per_sec"][2] > 0 and records[0]["export_img_per_sec"][2] > 0
    result = profile_step.collect("cifar", "rep", 4, 2, 1, device="cpu",
                                  compute_dtype=torch.float32)
    assert result["steps"] == 2 and result["steps_per_sec"] > 0
    assert any(scope.startswith("mmdgan_torch/ops/conv.py") for scope in result["modules"])
    lines = profile_step.report(result, top=3)
    assert sum(line.startswith("## ") for line in lines) == 3


def test_profile_raw_activities_equal_prof_events():
    """``profile_step.raw_activities``, which ``window_timeline`` reads on
    the card, holds the names and times that ``prof.events()`` gives, with
    its filters (the record_function bookkeeping ops go): here on host ops
    that nest no op in one of its own name, which ``prof.events()`` would
    merge (device kernels never nest). The collectives count reads it too."""
    from torch.profiler import ProfilerActivity, profile, record_function

    a = torch.tensor(np.random.RandomState(0).randn(64, 64).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("nccl:all_reduce"):
                a = torch.exp(a) * 0.5 + a
    cpu = torch.autograd.DeviceType.CPU
    got = profile_step.check_raw_activities(prof, cpu)
    names = [name for name, _, _ in profile_step.raw_activities(prof, cpu)]
    assert got["activities"] == len(names) >= 12 and got["ns"] > 0
    assert names.count("nccl:all_reduce") == 3 and not any("record_function" in n for n in names)
    assert profile_step.window_timeline(prof, 3, torch.device("cpu"))["nccl_ops"] == 3
