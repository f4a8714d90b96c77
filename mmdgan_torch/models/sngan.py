"""SNGan: generator + discriminator + repulsive MMD loss
(``mmdgan_tpu/models/sngan.py:35-45,69-238,357-444``).

Internally NCHW on ``self.device``. ``generate`` returns NHWC images and
data batches arrive NHWC (``{"x": [B, H, W, C]}``); ``to_nchw`` is the one
place the layout changes. ``gen_stage`` and ``dis_stage`` are the two
halves of the train step and work on NCHW tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from mmdgan_torch import DeviceLike, resolve_device
from mmdgan_torch.models.network import Net, Routine
from mmdgan_torch.ops.losses import GANLoss, LossState


def decode_image_batch(data_batch: Dict) -> Dict:
    """uint8 image batches become float32 in [-1, 1]; float batches pass
    through untouched (same x/127.5-1 as host decoding)."""
    x = data_batch.get("x")
    if isinstance(x, torch.Tensor) and x.dtype == torch.uint8:
        data_batch = dict(data_batch)
        data_batch["x"] = x.float() / 127.5 - 1.0
    return data_batch


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC image batch as NCHW."""
    return x.permute(0, 3, 1, 2)


class SNGan:
    def __init__(
        self,
        architecture: dict,
        loss_type: str = "rep",
        rep_weights: Sequence[float] = (0.0, -1.0),
        compute_dtype: torch.dtype = torch.bfloat16,
        use_fused_kernel: bool = True,
        do_summary: bool = True,
        device: DeviceLike = None,
    ):
        """:param architecture: dict with 'input' [(C, H, W)], 'code'
        [(code_size, act)], 'generator' and 'discriminator' layer lists, in
        the reference format (``mmdgan_torch.architectures``).
        :param device: ``cuda`` by default; raises without a GPU unless
        ``"cpu"`` is passed."""
        self.device = resolve_device(device)
        self.architecture = architecture
        self.loss_type = loss_type
        self.do_summary = do_summary
        self.channels, self.height, self.width = architecture["input"][0]
        self.code_size = architecture["code"][0][0]
        self.score_size = architecture["discriminator"][-1]["out"]
        self.compute_dtype = compute_dtype
        self.loss_hp = GANLoss(repulsive_weights=list(rep_weights),
                               use_fused_kernel=use_fused_kernel)
        self.Gen = Routine(Net(architecture["generator"], (self.code_size,),
                               net_name="gen", compute_dtype=compute_dtype))
        self.Dis = Routine(Net(architecture["discriminator"],
                               (self.channels, self.height, self.width),
                               net_name="dis", compute_dtype=compute_dtype))
        expect = (self.channels, self.height, self.width)
        assert tuple(self.Gen.output_shape) == expect, (
            f"generator output {self.Gen.output_shape} does not match data shape {expect}")

    def init(self, seed: int) -> Tuple[Dict, Dict, LossState]:
        """(params, net_state, loss_state) on ``self.device``; params have
        'gen'/'dis' sub-trees keyed like the JAX tree. The draws are made on
        the CPU, so a seed gives the same model on every device."""
        g = torch.Generator().manual_seed(int(seed))
        pg, sg = self.Gen.init(g)
        pd, sd = self.Dis.init(g)
        to_dev = lambda tree: {k: to_dev(v) if isinstance(v, dict) else v.to(self.device)
                               for k, v in tree.items()}
        return (to_dev({"gen": pg, "dis": pd}), to_dev({"gen": sg, "dis": sd}),
                LossState.init(self.device))

    def sample_codes(self, generator: Optional[torch.Generator], batch_size: int,
                     code_x=None) -> Dict[str, Optional[torch.Tensor]]:
        """z ~ N(0, 1) from ``generator``, or ``code_x`` as given."""
        if code_x is None:
            code_x = torch.randn(batch_size, self.code_size, generator=generator,
                                 device=self.device)
        else:
            code_x = torch.as_tensor(code_x, dtype=torch.float32, device=self.device)
            assert code_x.shape[0] == batch_size
        return {"x": code_x, "y": None}

    def generate(self, params: Dict, state: Dict, generator: Optional[torch.Generator] = None,
                 batch_size: Optional[int] = None, code_batch: Optional[Dict] = None,
                 clip: bool = True) -> torch.Tensor:
        """Eval-mode generation; returns NHWC float32 images."""
        if code_batch is None:
            code_batch = self.sample_codes(generator, batch_size)
        with torch.no_grad():
            x, _ = self.Gen.apply(params["gen"], state["gen"], code_batch["x"], train=False)
        x = x.permute(0, 2, 3, 1)
        return torch.clamp(x, -1.0, 1.0) if clip else x

    def gen_stage(self, params_gen: Dict, state: Dict, batch_size: int,
                  generator: Optional[torch.Generator] = None,
                  code_batch: Optional[Dict] = None, train: bool = True):
        """Generator half of the train step: returns (gen_x NCHW,
        gen_state, code_batch). ``code_batch`` overrides the z sampling."""
        code_batch = self.sample_codes(
            generator, batch_size, None if code_batch is None else code_batch["x"])
        gen_x, gen_state = self.Gen.apply(params_gen, state["gen"], code_batch["x"], train=train)
        return gen_x, gen_state, code_batch

    def dis_stage(self, params_dis: Dict, gen_x: torch.Tensor, state: Dict,
                  loss_state: LossState, x_real: torch.Tensor):
        """Discriminator + loss half: ONE D pass on concat(real, fake),
        real first. NCHW inputs. Returns (loss_gen, loss_dis, dis_state,
        new_loss_state, aux)."""
        batch_size = x_real.shape[0]
        dis_in = torch.cat([x_real, gen_x], dim=0)
        scores, dis_state = self.Dis.apply(params_dis, state["dis"], dis_in, train=True)
        s_x, s_gen = scores[:batch_size], scores[batch_size:]
        loss_gen, loss_dis, new_loss_state, loss_aux = self.loss_hp.apply(
            s_gen, s_x, self.loss_type, batch_size=batch_size, state=loss_state)
        aux = {
            "s_x_mean": torch.mean(s_x),
            "s_gen_mean": torch.mean(s_gen),
            "x_gen_abs_mean": torch.mean(torch.abs(gen_x)),
            **loss_aux,
        }
        return loss_gen, loss_dis, dis_state, new_loss_state, aux
