"""The readings a cell's limits are set from, on the card:

- ``program``: the cell's own runs (set-up, a short window, the check),
  one per seed, with every reading the check makes;
- ``control``: the plain reference put in the program's place in the
  next precision below the configuration's (float8: ``precision="fp8"``)
  against the float32 reference, on the same weights and inputs;
- ``faults``: the reference with each fault the cell can have planted
  (training: half of the batch left out, the mean taken over the rest; a
  state left unchanged reads 1 by the leaf measure and needs no run;
  serving: half of the rows left out, one answer altered).

    python3 benchmark/calibrate.py --workload cifar10.train --seeds 11,12,13 \\
        --what program,control,faults --seconds 1

One JSON line per (what, seed) on standard output. The benchmark's runs
never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def train_control(cell: dict, seed: int, device: str) -> dict:
    """{reading: value} of the fp8 control and of the half-batch fault, on
    the rows and codes the device sampler's cell draws (the host-fed cell's
    too: the control reads the configuration at its size, whichever rows)."""
    import torch

    from benchmark.drivers import _port, device_train
    from benchmark.reference import check, mmdgan

    cfg = cell["cfg"]
    dev = torch.device(device)
    s = _port.seeds(seed)
    specs = mmdgan.leaf_specs(cfg["architecture"])
    state0 = _port.make_state(cfg, specs, s["weights"], dev)
    rows = cfg["dataset"]["rows"]
    data = _port.make_images([rows] + cfg["dataset"]["shape_hwc"], s["data"], dev)
    draws = device_train.reference_draws(cfg, s, rows, cell["mix"]["warm_steps"][0], dev)
    ref = check.follow(cfg, specs, state0, data, draws, dev)
    out = {}
    for what, kw in (("control", {"precision": "fp8"}), ("half_batch", {"fault": "half_batch"})):
        side = check.follow(cfg, specs, state0, data, draws, dev, **kw)
        out[what] = check.train_gaps(cfg, specs, state0, side, ref)
    return out


def serve_control(cell: dict, seed: int, device: str) -> dict:
    import torch

    from benchmark.drivers import _port
    from benchmark.reference import check, mmdgan

    cfg, mix = cell["cfg"], cell["mix"]
    arch = cfg["architecture"]
    dev = torch.device(device)
    s = _port.seeds(seed)
    specs = {n: v for n, v in mmdgan.leaf_specs(arch).items() if n.startswith("gen/")}
    state0 = _port.make_state(cfg, specs, s["weights"], dev)
    g = torch.Generator(dev).manual_seed(s["window"])
    zs = [torch.randn(mix["batch"], arch["code"][0][0], generator=g, device=dev)
          for _ in range(4)]
    with mmdgan.float32_exact():
        ref = [mmdgan.generate(arch, state0, z).cpu().numpy() for z in zs]
        fp8 = [mmdgan.generate(arch, state0, z, precision="fp8").cpu().numpy() for z in zs]
        altered = [mmdgan.generate(arch, state0, torch.cat([-z[:1], z[1:]])).cpu().numpy()
                   for z in zs]
    half = [r.copy() for r in ref]
    for h in half:
        h[h.shape[0] // 2:] = 0.0
    return {"control": {"image_gap": check.serve_gap(fp8, ref)},
            "half_rows": {"image_gap": check.serve_gap(half, ref)},
            "altered": {"image_gap": check.serve_gap(altered, ref)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--what", default="program,control,faults")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from benchmark import harness

    spec = harness.load_spec(ROOT)
    harness.set_cache_dirs(ROOT)
    cell = harness.load_cell(spec, args.workload)
    what = set(args.what.split(","))
    for seed in (int(x) for x in args.seeds.split(",")):
        if "program" in what:
            t = time.perf_counter()
            res = harness.run_cell(spec, args.workload, seed, args.seconds, False,
                                   device=args.device)
            readings = {**res["observed"], **{n: c["value"] for n, c in res["compared"].items()}}
            print(json.dumps({"what": "program", "seed": seed, "readings": readings,
                              "correct": res["correct"], "metrics": res["metrics"],
                              "seconds": time.perf_counter() - t}), flush=True)
        if what & {"control", "faults"}:
            kind = cell["mix"]["kind"]
            out = (serve_control if kind == "serve_closed" else train_control)(
                cell, seed, args.device)
            for name, readings in out.items():
                if ("control" if name == "control" else "faults") in what:
                    print(json.dumps({"what": name, "seed": seed, "readings": readings}),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
