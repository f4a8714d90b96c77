"""Serving a trained generator for bulk sample generation: the generator
exported at a static batch (``export_generator``) and loaded back
(``load_exported``) in set-up, the restart users pay; then one client in a
closed loop for ``--seconds``: codes drawn on the device from the seed,
one call of the exported program, the images copied to host memory. Each
request is timed from the call until its images are on the host.

Every ``sample_every``-th request (from an offset drawn from the seed)
keeps its codes and served images; after the window the program is freed
and the reference generates from the same weights and codes.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import trace
from benchmark.drivers import _port
from benchmark.harness import compare
from benchmark.reference import check, mmdgan


def run(r) -> None:
    from mmdgan_torch.utils.export import export_generator, load_exported

    cfg, mix = r.cfg, r.mix
    dev = torch.device(r.device)
    s = _port.seeds(r.seed)
    arch = cfg["architecture"]
    b, code = mix["batch"], arch["code"][0][0]
    if mix["clients"] != 1:
        raise ValueError("the closed loop runs one client")
    h, w, c = cfg["dataset"]["shape_hwc"]
    specs = {n: v for n, v in mmdgan.leaf_specs(arch).items() if n.startswith("gen/")}
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        with r.spans("setup.model", sync=r.sync):
            model, _, _ = _port.build(cfg, dev)
            gen_params, gen_state = model.Gen.init(torch.Generator().manual_seed(s["init"]))
            to_dev = lambda tree: {  # noqa: E731
                k: to_dev(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}
            held = SimpleNamespace(params={"gen": to_dev(gen_params), "dis": {}},
                                   net_state={"gen": to_dev(gen_state), "dis": {}})
            state0 = _port.make_state(cfg, specs, s["weights"], dev)
            _port.write_state(held, state0)
        path = os.path.join(tmp, "generator.pt2")
        with r.spans("setup.export", sync=r.sync):
            export_generator(model, held.params, held.net_state, b, path, device=dev)
        del model, held
        with r.spans("setup.load", sync=r.sync):
            fn = load_exported(path, device=dev)
        g = torch.Generator(dev).manual_seed(s["window"])
        host = torch.empty((b, h, w, c), dtype=torch.float32, pin_memory=dev.type == "cuda")
        for _ in range(mix["warm_calls"]):
            host.copy_(fn(torch.randn(b, code, generator=g, device=dev)))

        every = mix["sample_every"]
        offset = s["sample"] % every
        kept, lat = [], []
        if r.trace:
            from torch.profiler import record_function

            r.setup_done()
            with trace.profiler(dev) as prof:
                with record_function("bench.serve_stretch"):
                    for i in range(mix["trace_calls"]):
                        z = torch.randn(b, code, generator=g, device=dev)
                        host.copy_(fn(z))
                        if i % every == offset:
                            kept.append((z, host.numpy().copy()))
            device_events, host_events = trace.activities(prof)
            r.stretch = trace.host_stretch(device_events, host_events, "bench.serve_stretch",
                                           mix["trace_calls"])
            r.attempted = mix["trace_calls"]
        else:
            r.setup_done()
            r.sync()
            start = time.perf_counter()
            i = 0
            while True:
                z = torch.randn(b, code, generator=g, device=dev)
                t = time.perf_counter()
                host.copy_(fn(z))
                end = time.perf_counter()
                lat.append(end - t)
                if i % every == offset:
                    kept.append((z, host.numpy().copy()))
                i += 1
                if end - start >= r.seconds:
                    break
            window = end - start
            r.attempted = i
            r.e2e["serve_img_per_s"] = b * i / window
            r.e2e["serve_call_ms_p95"] = float(np.percentile(lat, 95)) * 1e3
            kept.append((z, host.numpy().copy()))   # the last request, always

        del fn
        _port.release(r, dev)
        with mmdgan.float32_exact():
            ref = [mmdgan.generate(arch, state0, z).cpu().numpy() for z, _ in kept]
        compare(r, {"image_gap": check.serve_gap([img for _, img in kept], ref)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
