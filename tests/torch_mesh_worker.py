"""One gloo rank of the port's mesh, for ``tests/test_torch_mesh_ranks.py``.

    python tests/torch_mesh_worker.py CASES OUT RANK WORLD STORE

``CASES`` is a ``torch.save``d list of cases, each a dict: ``name``,
``arch``, ``loss_type``, ``num_class``, ``same_class``, ``micro`` (M),
``imbalanced`` (None or a schedule: the steps then run as one window of
``len(batches)``), ``ckpt`` (the starting TrainState's checkpoint file)
and ``batches``, a list of per-step dicts of GLOBAL numpy arrays: ``x``,
``y`` (or None), ``z``, ``uni`` (or None). Each rank joins a ``WORLD``-rank
gloo group through the ``file://`` store ``STORE``, runs every case (SGD
at 1e-2 on both networks, float32) on its rows of each global batch
(``DataParallel.local_rows``, micro-major for M > 1) with the global z
and interpolation weights, and saves to ``OUT/<name>_<RANK>.pt`` the
losses per step and every tensor of the final state with its generator.

A case may also name a sharded ``layout``: ``"fsdp"`` (``shard_state(...,
fsdp=True)`` on the 1-D mesh) or ``[D, M]`` (a 2-D mesh of the ranks,
``make_mesh_2d``), with ``min_size``; the state is then sharded after the
restore, the saved tensors are the gathered whole state's, and the result
records how many leaves were split and the rank's persistent bytes. With
``agent_dir`` the sharded state then trains 4 more steps through
``Agent.train`` in K=2 windows, which writes its checkpoint there, and the
result records whether the layout came back, and whether the starting
checkpoint restored into a freshly sharded state gives that checkpoint's
values back bitwise.
"""

import itertools
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmdgan_torch.models.sngan import SNGan  # noqa: E402
from mmdgan_torch.parallel.mesh import DataParallel, init_distributed, make_mesh_2d  # noqa: E402
from mmdgan_torch.train.optim import multi_opt_config  # noqa: E402
from mmdgan_torch.train.state import tree_leaves  # noqa: E402
from mmdgan_torch.train.step import (  # noqa: E402
    build_grad_accum_step,
    build_train_step,
    imbalanced_scan,
    init_train_state,
)
from mmdgan_torch.train.trainer import Agent  # noqa: E402
from mmdgan_torch.utils.checkpoint import restore_into  # noqa: E402


def state_bytes(ts) -> int:
    """Bytes of the parameters and optimizer slots a rank keeps between
    steps, summed from the state's tensors."""
    opt = [t for o in (ts.opt_state_dis, ts.opt_state_gen) for t in o.tensors()[1:]]
    return sum(t.numel() * t.element_size() for t in tree_leaves(ts.params) + opt)


def run_case(case: dict, dp: DataParallel):
    model = SNGan(case["arch"], num_class=case["num_class"], loss_type=case["loss_type"],
                  compute_dtype=torch.float32, device="cpu")
    model.sample_same_class = case["same_class"]
    opt_d, opt_g = multi_opt_config([1e-2, 1e-2], optimizer=case.get("optimizer", "sgd"))
    ts = restore_into(init_train_state(model, 0, opt_d, opt_g, device="cpu"), case["ckpt"])
    layout = case.get("layout")
    if layout is not None:
        if layout != "fsdp":
            dp = DataParallel(make_mesh_2d(*layout), device="cpu")
        ts = dp.shard_state(ts, min_size=case["min_size"], fsdp=layout == "fsdp")
    m = case["micro"]
    step = (build_train_step(model, opt_d, opt_g, device="cpu", dp=dp) if m == 1 else
            build_grad_accum_step(model, opt_d, opt_g, m, device="cpu", dp=dp))
    local = lambda a: None if a is None else dp.local_rows(torch.as_tensor(a), m)  # noqa: E731
    batches = case["batches"]
    if case["imbalanced"] is not None:
        stack = lambda key: (None if batches[0][key] is None else  # noqa: E731
                             torch.stack([local(b[key]) for b in batches]))
        window = imbalanced_scan(step, len(batches), case["imbalanced"], capture=False)
        ts, metrics = window(ts, {"x": stack("x"), "y": stack("y")}, None, torch.zeros(()),
                             code_batches={"x": torch.stack([torch.as_tensor(b["z"])
                                                             for b in batches])})
        losses = torch.stack([metrics["loss_gen"], metrics["loss_dis"]], 1)
        do_dis = metrics["do_dis"]
    else:
        losses = []
        for b in batches:
            kw = {} if b["uni"] is None else {"uni": b["uni"]}
            ts, metrics = step(ts, {"x": local(b["x"]), "y": local(b["y"])},
                               code_batch={"x": b["z"]}, **kw)
            losses.append(torch.stack([metrics["loss_gen"], metrics["loss_dis"]]))
        losses, do_dis = torch.stack(losses), None
    out = {"losses": losses, "do_dis": do_dis}
    if layout is not None:
        out.update(sharded=ts.layout.sharded_leaves, bytes=state_bytes(ts))
        whole = ts.layout.gathered(ts)
        out.update(tensors=[t.detach().clone() for t in whole.tensors()],
                   rng=whole.rng.get_state())
        if case.get("agent_dir"):
            out.update(agent_run(case, dp, step, ts, local, opt_d, opt_g, model))
        return out
    out.update(tensors=[t.detach() for t in ts.tensors()], rng=ts.rng.get_state())
    return out


def agent_run(case, dp, step, ts, local, opt_d, opt_g, model):
    sharded = ts.layout.sharded_leaves
    agent = Agent(case["name"], "t", output_dir=case["agent_dir"], print_loss=False,
                  use_tensorboard=False, query_step=2)
    data = ({"x": local(b["x"])} for b in itertools.cycle(case["batches"]))
    after = agent.train(step, ts, data, max_step=4, step_per_epoch=4, dp=dp, steps_per_call=2)
    fresh = dp.shard_state(init_train_state(model, 1, opt_d, opt_g, device="cpu"),
                           min_size=case["min_size"], fsdp=case["layout"] == "fsdp")
    restore_into(fresh, case["ckpt"])
    plain = restore_into(init_train_state(model, 1, opt_d, opt_g, device="cpu"), case["ckpt"])
    same = all(torch.equal(a, b) for a, b in zip(fresh.layout.gathered(fresh).tensors(),
                                                  plain.tensors()))
    return {"agent_step": int(after.step), "agent_ckpt": agent.ckpt_folder,
            "agent_tensors": [t.detach() for t in after.layout.gathered(after).tensors()],
            "agent_kept_layout": after is ts and after.layout is not None
            and after.layout.sharded_leaves == sharded,
            "restored_sharded_bitwise": same}


def main(cases_path: str, out: str, rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    init_distributed("gloo", f"file://{store}", rank, world)
    dp = DataParallel(device="cpu")
    for case in torch.load(cases_path, weights_only=False):
        torch.save(run_case(case, dp), os.path.join(out, f"{case['name']}_{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
