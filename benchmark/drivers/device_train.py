"""Training over a dataset that lives on the card, as the CLI runs it with
``--device-dataset``: ``Agent.train_device_data`` with graphed K-step
windows, the uniform sampler on the device and the CUDA kernel pair.

Set-up builds the model, its optimisers, one TrainState and one Agent,
writes the benchmark's weights into the state, and drives them through
the check's steps by the window's own agent, call and feed: one call of
one step (a call shorter than K runs a window of its length), after which
Adam's slots give the first gradient; one call of two single-step
windows, the second captured and replayed; then one call of
``warm_steps[0]`` steps in K-step windows, the first eager, the next
captured and replayed, with the window function the timed call replays.
It keeps what the reference needs: the state before, Adam's slots after
step 1, the whole state after step 3 and after the last check step, and
the metrics the program reports (each call's last step). The single-step
graph stays alive in the Agent: without a live graph, the next call's
capture of the K-step window trips the caching allocator's pool assert
(PERF.md, Open questions). The K-step call is also the first warming
call; the next one's rate, its upload and warm-up included, sizes the
window. The window is one call of ``max_step`` steps, a multiple of K,
lasting about ``--seconds``; it pays one dataset upload and one warm-up
and capture of its graphs, as each chunk of the CLI does. Traced, one
call of ``trace_windows`` + 3 windows runs under the profiler instead,
and the stretch is its replays 2 .. ``trace_windows`` + 1.

After the window the program's state is freed and the reference follows
the check's steps from the same weights, rows and codes: the rows drawn
by the sampler's documented stream (``randint`` from a generator seeded
``seed + 54321`` per call) and the codes by the state's generator, which
the benchmark seeds.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import torch

from benchmark import trace
from benchmark.drivers import _port
from benchmark.harness import compare
from benchmark.reference import check, mmdgan

SAMPLER_SEED_OFFSET = 54321   # Agent.train_device_data: Generator(seed + 54321)


def _metrics(path: str) -> Dict[int, dict]:
    """The scalar records of a run's metrics.jsonl, by step."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "loss_gen" in rec:
                out[int(rec["step"])] = rec
    return out


def run(r) -> None:
    from mmdgan_torch.train.step import init_train_state
    from mmdgan_torch.train.trainer import Agent

    cfg, mix = r.cfg, r.mix
    dev = torch.device(r.device)
    s = _port.seeds(r.seed)
    arch = cfg["architecture"]
    b, k = cfg["batch_size"], mix["steps_per_call"]
    rows = cfg["dataset"]["rows"]
    specs = mmdgan.leaf_specs(arch)
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        with r.spans("setup.model", sync=r.sync):
            model, opt_d, opt_g = _port.build(cfg, dev)
            ts = init_train_state(model, s["init"], opt_d, opt_g, device=dev)
            state0 = _port.make_state(cfg, specs, s["weights"], dev)
            _port.write_state(ts, state0)
            ts.rng.manual_seed(s["z"])
        with r.spans("setup.data", sync=r.sync):
            data = {"x": _port.make_images([rows] + cfg["dataset"]["shape_hwc"], s["data"],
                                           dev), "y": None}
        kw = dict(step_per_epoch=rows // b, batch_size=b, sampling=mix["sampling"])
        agent = Agent("bench", "run", do_save=False, output_dir=tmp, use_tensorboard=False)
        check_steps = mix["warm_steps"][0]

        with r.spans("setup.check", sync=r.sync):
            ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=1,
                                         steps_per_call=k, seed=s["call1"], **kw)
            mu1 = {n: _port.leaf(ts, n, "mu").detach().to("cpu", torch.float32, copy=True)
                   for n, v in specs.items() if v["group"] == "param"}
            ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=2,
                                         steps_per_call=1, seed=s["call2"], **kw)
            state3 = _port.read_state(ts, specs)
        with r.spans("setup.capture", sync=r.sync):
            ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=check_steps,
                                         steps_per_call=k, seed=s["warm1"], **kw)
        with r.spans("setup.check", sync=r.sync):
            state_end = _port.read_state(ts, specs)
            reported = _metrics(agent.writer.jsonl_path)
        with r.spans("setup.rate", sync=r.sync):
            ts = agent.train_device_data(model, opt_d, opt_g, ts, data,
                                         max_step=mix["warm_steps"][1], steps_per_call=k,
                                         seed=s["warm2"], **kw)
        rate = mix["warm_steps"][1] / r.spans.seconds["setup.rate"]

        start_step = int(ts.step)
        if r.trace:
            windows = mix["trace_windows"] + 3
            r.setup_done()
            with trace.profiler(dev) as prof:
                ts = agent.train_device_data(model, opt_d, opt_g, ts, data,
                                             max_step=windows * k, steps_per_call=k,
                                             seed=s["trace"], **kw)
                r.sync()
            device_events, host_events = trace.activities(prof)
            r.stretch = trace.graph_stretch(device_events, host_events, 1,
                                            mix["trace_windows"], k)
            if r.stretch is None:
                launches = [e for e in host_events if e[0].startswith("cudaGraphLaunch")]
                linked = {e[3] for e in launches} & {e[3] for e in device_events}
                print(f"benchmark: no stretch of {mix['trace_windows']} replays in the trace: "
                      f"{len(launches)} graph launches, {len(linked)} linked to device "
                      f"activity", file=sys.stderr)
            r.attempted = int(ts.step) - start_step
        else:
            max_step = max(k, int(round(r.seconds * rate / k)) * k)
            r.setup_done()
            r.sync()
            t0 = time.perf_counter()
            ts = agent.train_device_data(model, opt_d, opt_g, ts, data, max_step=max_step,
                                         steps_per_call=k, seed=s["window"], **kw)
            r.sync()
            seconds = time.perf_counter() - t0
            steps = int(ts.step) - start_step
            r.attempted = steps
            _port.report_train(r, steps, seconds)

        # the program's state goes before the reference runs
        del agent, ts, model, opt_d, opt_g
        _port.release(r, dev)
        draws = reference_draws(cfg, s, rows, check_steps, dev)
        end = check.START + check_steps
        program = ({i: reported[i] for i in (1, check.START, end)}, mu1,
                   {check.START: state3, end: state_end})
        reference = check.follow(cfg, specs, state0, data["x"], draws, dev)
        readings = check.train_gaps(cfg, specs, state0, program, reference)
        compare(r, readings)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reference_draws(cfg: dict, s: Dict[str, int], rows: int, check_steps: int,
                    dev: torch.device) -> List[tuple]:
    """(row indices, codes) of the check's steps, drawn again from the
    streams the program drew them from: the sampler's generator of each
    call (step 1; steps 2-3; then ``check_steps`` more), and the state's
    generator, seeded ``s['z']``, one draw a step."""
    b, code = cfg["batch_size"], cfg["architecture"]["code"][0][0]

    def sampler(seed: int):
        return torch.Generator(dev).manual_seed(seed + SAMPLER_SEED_OFFSET)

    g1, g2, g3 = sampler(s["call1"]), sampler(s["call2"]), sampler(s["warm1"])
    gz = torch.Generator(dev).manual_seed(s["z"])
    idx = [torch.randint(0, rows, (b,), generator=g, device=dev)
           for g in [g1] + [g2] * 2 + [g3] * check_steps]
    zs = [torch.randn(b, code, generator=gz, device=dev) for _ in idx]
    return [(i.cpu().numpy(), z) for i, z in zip(idx, zs)]
