"""SNGan: generator + discriminator + the GAN losses and their penalties
(``mmdgan_tpu/models/sngan.py:35-66,69-328,357-444``).

Internally NCHW shapes on ``self.device``; on the card under 16-bit
compute the memory is NHWC (``channels_last``, ``models/ops.py``
``nhwc_route``). ``generate`` returns NHWC images and data batches arrive
NHWC (``{"x": [B, H, W, C]}``); ``to_nchw`` is the one place the shape
changes. ``gen_stage`` and ``dis_stage`` are the two halves of the train
step and work on NCHW-shaped tensors.

With ``num_class`` >= 2 the model is class-conditional: code batches
carry labels ``y`` ([N, 1] int64, drawn uniformly unless given), the
generator and the discriminator take them (``label=``), D scores
concat(real, fake) against concat(real labels, code labels), and the
penalties score their interpolates against the real batch's labels
(``mmdgan_tpu/models/sngan.py:262-330,412``). ``sample_same_class`` makes
the code labels those of the real batch (``:375-378``).

With a mesh (``dp``, a ``parallel.DataParallel``) the two stages keep the
global-batch semantics of one device at the global batch: z, the code
labels and the penalty's interpolation weights are drawn at the global
batch from the replicated generator and each rank takes its rows; the
scores are gathered before the loss (whose draws are then the same on
every rank) and the witness; BN statistics, the penalty means, the
Jacobian scale's mean and the aux means are global
(``parallel/collectives.py``).

The penalties (WGAN-GP, the MMD witness penalty, the scaled-MMD Jacobian
scale) score their inputs with ``train=False`` and take their gradient
with ``create_graph=True``: the step differentiates through it again
(double backward through the spectral norm, the convs and the lrelu).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mmdgan_torch import DeviceLike, resolve_device
from mmdgan_torch.models.network import Net, Routine
from mmdgan_torch.ops.distance import get_squared_dist
from mmdgan_torch.ops.kernels import witness_g, witness_mix_g, witness_mix_t
from mmdgan_torch.ops.losses import GANLoss, LossState
from mmdgan_torch.parallel.collectives import all_gather, batch_mean, gathered_mean

GP_LOSSES = ("rep_gp", "rmb_gp", "fixed_g_gp", "fixed_t_gp")
DS_LOSSES = ("rep_ds", "rmb_ds")


def decode_image_batch(data_batch: Dict) -> Dict:
    """uint8 image batches become float32 in [-1, 1]; float batches pass
    through untouched (same x/127.5-1 as host decoding)."""
    x = data_batch.get("x")
    if isinstance(x, torch.Tensor) and x.dtype == torch.uint8:
        data_batch = dict(data_batch)
        data_batch["x"] = x.float() / 127.5 - 1.0
    return data_batch


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC image batch as an NCHW-shaped view: its memory stays NHWC,
    which is ``channels_last``, the layout the card's 16-bit convs take."""
    return x.permute(0, 3, 1, 2)


def _input_grad(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d sum(out) / d x, itself differentiable, one row per sample."""
    (g,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    return g.reshape(g.shape[0], -1)


def _norm_penalty(g: torch.Tensor, dp=None) -> torch.Tensor:
    """E (||g|| - 1)^2 with ||g|| = sqrt(sum g^2 + 1e-12): the eps keeps
    the second-order step finite where a gradient is 0. The mean is over
    the global batch under a mesh."""
    norm = torch.sqrt(torch.sum(torch.square(g), dim=1) + 1e-12)
    return batch_mean(torch.square(norm - 1.0), dp)


def _differentiable(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the graph already reaches it, else a leaf that requires grad."""
    return x if x.requires_grad else x.detach().requires_grad_(True)


def jacobian_squared_frobenius_norm(fwd: Callable, x: torch.Tensor) -> torch.Tensor:
    """[N]: sum_j ||d fwd(x)_{n,j} / d x_n||^2 per sample, one
    vector-Jacobian product per output dimension, each differentiable."""
    x = _differentiable(x)
    y = fwd(x)
    total = 0.0
    for j in range(y.shape[-1]):
        (g,) = torch.autograd.grad(y[:, j].sum(), x, create_graph=True, retain_graph=True)
        total = total + torch.sum(torch.square(g.reshape(g.shape[0], -1)), dim=1)
    return total


def gather_scores(scores: torch.Tensor, dp) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s_x, s_gen) of the global batch from each rank's scores of
    concat(real, fake): one differentiable gather (``all_gather``), then
    the real and the generated rows of every rank, in rank order."""
    n, d = scores.shape[0] // 2, scores.shape[1]
    both = all_gather(scores, dp).view(dp.size, 2, n, d)
    return both[:, 0].reshape(dp.size * n, d), both[:, 1].reshape(dp.size * n, d)


class SNGan:
    def __init__(
        self,
        architecture: dict,
        num_class: int = 0,
        loss_type: str = "rep",
        rep_weights: Sequence[float] = (0.0, -1.0),
        penalty_weight: float = 0.1,
        gp_weight: float = 10.0,
        compute_dtype: torch.dtype = torch.bfloat16,
        use_fused_kernel: bool = True,
        sigma: Optional[Sequence[float]] = None,
        summary_histograms: bool = False,
        do_summary: bool = True,
        init_mode: str = "default",
        sn_mode: str = "pico",
        device: DeviceLike = None,
    ):
        """:param architecture: dict with 'input' [(C, H, W)], 'code'
        [(code_size, act)], 'generator' and 'discriminator' layer lists, in
        the reference format (``mmdgan_torch.architectures``).
        :param penalty_weight: the Jacobian scale's weight (``*_ds``)
        :param gp_weight: the gradient penalties' weight (``*_gp``,
            ``wasserstein``)
        :param sigma: the Gaussian mixture's sigmas (``GANLoss.sigma``)
        :param summary_histograms: ``hist/*`` counts in the step metrics
        :param num_class: number of data classes (0/1 = unconditional)
        :param init_mode: 'default' | 'sn_paper' | 'pg_paper' kernel init
        :param sn_mode: 'pico' (power iteration on the layer operator) or
            'pim' / 'sn_paper' (on the conv kernel as a matrix)
        :param device: ``cuda`` by default; raises without a GPU unless
            ``"cpu"`` is passed."""
        self.device = resolve_device(device)
        self.architecture = architecture
        self.loss_type = loss_type
        self.num_class = int(num_class)
        self.sample_same_class = False
        self.do_summary = do_summary
        self.channels, self.height, self.width = architecture["input"][0]
        self.code_size = architecture["code"][0][0]
        self.score_size = architecture["discriminator"][-1]["out"]
        self.penalty_weight = penalty_weight
        self.gp_weight = gp_weight
        self.compute_dtype = compute_dtype
        self.loss_hp = GANLoss(repulsive_weights=list(rep_weights),
                               use_fused_kernel=use_fused_kernel,
                               summary_histograms=summary_histograms,
                               **({"sigma": tuple(sigma)} if sigma is not None else {}))
        self.Gen = self._routine(architecture["generator"], "gen", (self.code_size,),
                                 init_mode, sn_mode)
        self.Dis = self._routine(architecture["discriminator"], "dis",
                                 (self.channels, self.height, self.width), init_mode, sn_mode)
        expect = (self.channels, self.height, self.width)
        assert tuple(self.Gen.output_shape) == expect, (
            f"generator output {self.Gen.output_shape} does not match data shape {expect}")

    def _routine(self, design, name, input_shape, init_mode, sn_mode) -> Routine:
        """A chain of the net's layers (my_sngan.py:85-108)."""
        net = Net(design, net_name=name, num_class=self.num_class, init_mode=init_mode,
                  sn_mode=sn_mode, compute_dtype=self.compute_dtype)
        routine = Routine(net)
        routine.add_input_layers(input_shape, [0])
        routine.seq_links(list(range(net.num_layers)))
        routine.add_output_layers([net.num_layers - 1])
        return routine

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

    def as_labels(self, y, batch_size: int) -> Optional[torch.Tensor]:
        """Labels as [N, 1] int64 on the device: an int fills the batch."""
        if y is None:
            return None
        if isinstance(y, int):
            return torch.full((batch_size, 1), y, dtype=torch.int64, device=self.device)
        y = torch.as_tensor(y, device=self.device).long()
        return y[:, None] if y.dim() == 1 else y

    def sample_codes(self, generator: Optional[torch.Generator], batch_size: int,
                     code_x=None, code_y=None,
                     draw_labels: bool = True) -> Dict[str, Optional[torch.Tensor]]:
        """z ~ N(0, 1) and, for a conditional model, labels ~ U{0..C-1}
        (my_sngan.py:111-149), drawn from ``generator`` in that order, or
        as given: ``code_y`` an int, [N] or [N, 1]. Labels come out [N, 1]
        int64 on the model's device; None when not given and not
        ``draw_labels``."""
        if code_x is None:
            code_x = torch.randn(batch_size, self.code_size, generator=generator,
                                 device=self.device)
        else:
            code_x = torch.as_tensor(code_x, dtype=torch.float32, device=self.device)
            assert code_x.shape[0] == batch_size
        if self.num_class < 2 or (code_y is None and not draw_labels):
            return {"x": code_x, "y": None}
        if code_y is None:
            dev = self.device if generator is None else generator.device
            code_y = torch.randint(0, self.num_class, (batch_size, 1), generator=generator,
                                   device=dev)
        return {"x": code_x, "y": self.as_labels(code_y, batch_size)}

    def generate(self, params: Dict, state: Dict, generator: Optional[torch.Generator] = None,
                 batch_size: Optional[int] = None, code_batch: Optional[Dict] = None,
                 clip: bool = True, labels=None) -> torch.Tensor:
        """Eval-mode generation; returns NHWC float32 images. ``labels``
        (an int, [N] or [N, 1]) are the classes of a conditional model;
        [N] labels set the batch size when it is not given. Ignored when
        ``code_batch`` is given (its 'y' holds the labels)."""
        if code_batch is None:
            if labels is not None and batch_size is None and not isinstance(labels, int):
                batch_size = len(labels)
            code_batch = self.sample_codes(generator, batch_size, code_y=labels)
        label = self.as_labels(code_batch.get("y"), code_batch["x"].shape[0])
        with torch.no_grad():
            x, _ = self.Gen.apply(params["gen"], state["gen"],
                                  torch.as_tensor(code_batch["x"], device=self.device),
                                  train=False, label=label)
        x = x.permute(0, 2, 3, 1)
        return torch.clamp(x, -1.0, 1.0) if clip else x

    def discriminate(self, params: Dict, state: Dict, batch, train: bool = False,
                     labels=None) -> torch.Tensor:
        """Scores [N, d] of a batch: a {'x': ..., 'y': ...} dict, or an NHWC
        image array (uint8 or float) with its class ``labels``."""
        if isinstance(batch, dict):
            x, labels = batch["x"], batch.get("y")
        else:
            x = batch
        x = to_nchw(decode_image_batch({"x": torch.as_tensor(x, device=self.device)})["x"])
        out, _ = self.Dis.apply(params["dis"], state["dis"], x, train=train,
                                label=self.as_labels(labels, x.shape[0]))
        return out

    @staticmethod
    def concat_two_batches(batch1: Dict, batch2: Dict) -> Dict:
        """my_sngan.py:243-256: x stacked, y stacked when both have it."""
        y1, y2 = batch1.get("y"), batch2.get("y")
        return {"x": torch.cat([batch1["x"], batch2["x"]], dim=0),
                "y": None if y1 is None or y2 is None else torch.cat([y1, y2], dim=0)}

    # ------------------------------------------------------------------
    # gradient penalties (my_sngan.py:152-240), on NCHW images
    # ------------------------------------------------------------------
    def _dis_fwd(self, params_d: Dict, state: Dict, x: torch.Tensor,
                 labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        out, _ = self.Dis.apply(params_d, state["dis"], x, train=False, label=labels)
        return out

    def _interpolates(self, x, x_gen, generator, uni):
        if uni is None:
            uni = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=x.device)
        return _differentiable(x * uni + x_gen * (1.0 - uni))

    def gradient_penalty(self, params_d: Dict, state: Dict, x: torch.Tensor,
                         x_gen: torch.Tensor, generator: Optional[torch.Generator] = None,
                         uni: Optional[torch.Tensor] = None,
                         labels: Optional[torch.Tensor] = None, dp=None) -> torch.Tensor:
        """WGAN-GP: E (||d D(x_hat) / d x_hat|| - 1)^2 over interpolates
        with weights ``uni`` [N, 1, 1, 1] (drawn from ``generator`` when
        not given), scored against ``labels`` (the real batch's); E over
        the global batch under a mesh (``dp``)."""
        x_hat = self._interpolates(x, x_gen, generator, uni)
        return _norm_penalty(_input_grad(self._dis_fwd(params_d, state, x_hat, labels), x_hat),
                             dp)

    def mmd_gradient_penalty(self, params_d: Dict, state: Dict, x: torch.Tensor,
                             x_gen: torch.Tensor, s_x: torch.Tensor, s_gen: torch.Tensor,
                             mode: str = "rep_gp", generator: Optional[torch.Generator] = None,
                             uni: Optional[torch.Tensor] = None,
                             labels: Optional[torch.Tensor] = None, dp=None) -> torch.Tensor:
        """The MMD witness gradient penalty at interpolates, the witness
        taken against the step's scores ``s_x`` and ``s_gen`` (the global
        ones under a mesh, whose penalty mean is global too)."""
        x_hat = self._interpolates(x, x_gen, generator, uni)
        s_hat = self._dis_fwd(params_d, state, x_hat, labels)
        dist_zx = get_squared_dist(s_hat, s_x, mode="xy")
        dist_zy = get_squared_dist(s_hat, s_gen, mode="xy")
        if mode == "fixed_g_gp":
            wit = witness_mix_g(dist_zx, dist_zy,
                                sigma=[1.0, np.sqrt(2.0), 2.0, np.sqrt(8.0), 4.0])
        elif mode == "fixed_t_gp":
            wit = witness_mix_t(dist_zx, dist_zy, alpha=[0.25, 0.5, 0.9, 2.0, 25.0], beta=2.0)
        elif mode in ("rep_gp", "rmb_gp"):
            wit = witness_g(dist_zx, dist_zy, sigma=1.0)
        else:
            raise NotImplementedError(f"gradient penalty: {mode} not implemented")
        return _norm_penalty(_input_grad(wit, x_hat), dp)

    def mmd_gradient_scale(self, params_d: Dict, state: Dict, x: torch.Tensor,
                           labels: Optional[torch.Tensor] = None, dp=None) -> torch.Tensor:
        """The scaled-MMD discriminator scale 1 / (w E||J||_F^2 + 1), E
        over the global batch under a mesh."""
        jaco = jacobian_squared_frobenius_norm(
            lambda xx: self._dis_fwd(params_d, state, xx, labels), x)
        return 1.0 / (self.penalty_weight * batch_mean(jaco, dp) + 1.0)

    def step_codes(self, generator: Optional[torch.Generator], batch_size: int,
                   code_batch: Optional[Dict] = None, data_y: Optional[torch.Tensor] = None,
                   dp=None, micro_batches: int = 1) -> Dict[str, Optional[torch.Tensor]]:
        """A train step's codes (``sample_codes``): ``code_batch`` overrides
        the z (and label) draws; with ``sample_same_class`` the code labels
        are ``data_y``. With a mesh, ``batch_size`` is the rank's, the codes
        are drawn (or given) at the global batch and the rank takes its
        rows (``DataParallel.local_rows``, micro-major over
        ``micro_batches``); same-class labels are the rank's own
        ``data_y``."""
        code_batch = code_batch or {}
        code_y = code_batch.get("y")
        same = code_y is None and self.sample_same_class and data_y is not None
        if same:
            code_y = data_y
        if dp is None:
            return self.sample_codes(generator, batch_size, code_batch.get("x"), code_y)
        codes = self.sample_codes(generator, batch_size * dp.size, code_batch.get("x"),
                                  None if same else code_y, draw_labels=not same)
        codes = {k: None if v is None else dp.local_rows(v, micro_batches)
                 for k, v in codes.items()}
        if same:
            codes["y"] = self.as_labels(data_y, batch_size)
        return codes

    def gen_stage(self, params_gen: Dict, state: Dict, batch_size: int,
                  generator: Optional[torch.Generator] = None,
                  code_batch: Optional[Dict] = None, train: bool = True,
                  data_y: Optional[torch.Tensor] = None, dp=None):
        """Generator half of the train step: returns (gen_x NCHW,
        gen_state, code_batch), the codes from ``step_codes``."""
        code_batch = self.step_codes(generator, batch_size, code_batch, data_y, dp)
        gen_x, gen_state = self.Gen.apply(params_gen, state["gen"], code_batch["x"], train=train,
                                          label=code_batch["y"], dp=dp)
        return gen_x, gen_state, code_batch

    def dis_stage(self, params_dis: Dict, gen_x: torch.Tensor, state: Dict,
                  loss_state: LossState, x_real: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  y_real: Optional[torch.Tensor] = None, code_y: Optional[torch.Tensor] = None,
                  uni=None, dp=None):
        """Discriminator + loss half: ONE D pass on concat(real, fake),
        real first, against concat(``y_real``, ``code_y``) for a
        conditional model, then the penalty or scale (on the real labels),
        then the loss. NCHW inputs. The loss's draws, then the penalty's
        (unless ``uni`` gives its interpolation weights, [B, 1, 1, 1] at the
        global batch), come from ``generator`` in that order. Under a mesh
        the scores are gathered (``gather_scores``) before the loss and the
        witness. Returns (loss_gen, loss_dis, dis_state, new_loss_state,
        aux)."""
        batch_size = x_real.shape[0]
        dis_in = self.concat_two_batches({"x": x_real, "y": y_real}, {"x": gen_x, "y": code_y})
        scores, dis_state = self.Dis.apply(params_dis, state["dis"], dis_in["x"], train=True,
                                           label=dis_in["y"], dp=dp)
        if dp is None:
            s_x, s_gen = scores[:batch_size], scores[batch_size:]
        else:
            s_x, s_gen = gather_scores(scores, dp)
        draws = self.loss_hp.draw(self.loss_type, s_gen, generator)
        if uni is not None:
            uni = torch.as_tensor(uni, dtype=torch.float32, device=x_real.device)
        if dp is not None and self.loss_type in GP_LOSSES + ("wasserstein",):
            if uni is None:
                uni = torch.rand((s_x.shape[0], 1, 1, 1), generator=generator,
                                 device=x_real.device)
            uni = dp.local_rows(uni)
        dis_penalty = dis_scale = None
        if self.loss_type in GP_LOSSES:
            dis_penalty = self.gp_weight * self.mmd_gradient_penalty(
                params_dis, state, x_real, gen_x, s_x, s_gen, mode=self.loss_type,
                generator=generator, uni=uni, labels=y_real, dp=dp)
        elif self.loss_type == "wasserstein":
            dis_penalty = self.gp_weight * self.gradient_penalty(
                params_dis, state, x_real, gen_x, generator=generator, uni=uni, labels=y_real,
                dp=dp)
        elif self.loss_type in DS_LOSSES:
            dis_scale = self.mmd_gradient_scale(params_dis, state, x_real, labels=y_real, dp=dp)
        loss_gen, loss_dis, new_loss_state, loss_aux = self.loss_hp.apply(
            s_gen, s_x, self.loss_type, batch_size=s_x.shape[0], d=self.score_size,
            dis_penalty=dis_penalty, dis_scale=dis_scale, state=loss_state, draws=draws)
        aux = {
            "s_x_mean": torch.mean(s_x),
            "s_gen_mean": torch.mean(s_gen),
            "x_gen_abs_mean": gathered_mean(torch.abs(gen_x), dp),
            **loss_aux,
        }
        return loss_gen, loss_dis, dis_state, new_loss_state, aux

    # ------------------------------------------------------------------
    # evaluation (my_sngan.py:499-649)
    # ------------------------------------------------------------------
    def eval_sampling(
        self,
        params: Dict,
        state: Dict,
        filename: str,
        sub_folder: str,
        mesh_num: Tuple[int, int] = (10, 10),
        mesh_mode=0,
        code_x=None,
        code_y=None,
        real_batch: Optional[Dict] = None,
        get_dis_score: bool = True,
        do_sprite: bool = True,
        do_embedding: bool = False,
        if_invert: bool = False,
        generator: Optional[torch.Generator] = None,
        output_dir: Optional[str] = None,
        global_step: int = 0,
    ) -> Dict:
        """A sample grid from ``code_x`` or MeshCode latents (drawn from the
        CPU ``generator``); writes the sprite PNGs and, with
        ``do_embedding``, a TensorBoard-projector embedding of the scores
        (``mmdgan_tpu/models/sngan.py:449-533``). A conditional model
        generates ``code_y``'s classes, the real batch's under
        ``sample_same_class``, else classes drawn from ``generator`` (a
        CPU generator seeded 0 when None). Returns the file paths and
        arrays (``x_gen``, ``s_x``, ``s_gen`` as numpy)."""
        from mmdgan_torch.ops.mesh_code import MeshCode
        from mmdgan_torch.utils.folders import prepare_folder
        from mmdgan_torch.utils.sprite import embedding_image_wrapper, write_sprite_wrapper

        _, summary_folder, _ = prepare_folder(filename, sub_folder=sub_folder,
                                              set_folder=output_dir)
        batch_size = mesh_num[0] * mesh_num[1]
        if code_x is None:
            code_x = MeshCode(self.code_size, mesh_num=mesh_num).get_batch(
                mesh_mode, generator=generator)
        if code_y is None and self.sample_same_class and real_batch is not None:
            code_y = real_batch.get("y")
        if code_y is None and self.num_class >= 2 and generator is None:
            generator = torch.Generator().manual_seed(0)
        code_batch = self.sample_codes(generator, batch_size, code_x, code_y)
        x_gen = self.generate(params, state, code_batch=code_batch)
        out = {"x_gen": x_gen.cpu().numpy()}
        real_x = None
        if real_batch is not None:
            real_x = decode_image_batch(
                {"x": torch.as_tensor(real_batch["x"], device=self.device)})["x"]
            real_np = real_x.cpu().numpy()

        if get_dis_score and real_x is not None:
            both = self.concat_two_batches(
                {"x": real_x, "y": self.as_labels(real_batch.get("y"), batch_size)},
                {"x": x_gen, "y": code_batch["y"]})
            with torch.no_grad():
                scores = self.discriminate(params, state, both)
            out["s_x"], out["s_gen"] = (s.cpu().numpy() for s in torch.chunk(scores, 2))

        index = f"{sub_folder}_{global_step}_{mesh_mode}"
        if do_sprite:
            if real_x is not None:
                out["sprite_real"] = write_sprite_wrapper(
                    real_np, mesh_num, filename, file_folder=summary_folder,
                    file_index=f"_r_{index}", if_invert=if_invert)
            out["sprite_gen"] = write_sprite_wrapper(
                out["x_gen"], mesh_num, filename, file_folder=summary_folder,
                file_index=f"_g_{index}", if_invert=if_invert)

        if do_embedding and "s_x" in out:
            labels = np.concatenate([np.ones(batch_size, np.int64),
                                     np.zeros(batch_size, np.int64)])
            out["embedding"] = embedding_image_wrapper(
                np.concatenate([out["s_x"], out["s_gen"]], axis=0), filename,
                var_name="x_vs_xg", file_folder=summary_folder,
                file_index=f"_x_vs_xg_{index}", labels=labels,
                images=np.concatenate([real_np, out["x_gen"]], axis=0),
                mesh_num=(mesh_num[0] * 2, mesh_num[1]), if_invert=if_invert)
        return out

    def mdl_score(
        self,
        params: Dict,
        state: Dict,
        real_batches,
        batch_size: int = 64,
        num_batch: int = 10,
        model: str = "v1",
        model_path: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        classifier: Optional[Callable] = None,
        seconds: Optional[Dict[str, float]] = None,
    ):
        """IS/FID, or MS-SSIM, of the model's samples against real batches
        (``mmdgan_tpu/models/sngan.py:535-590``; my_sngan.py:602-649).

        :param real_batches: an iterator of batches, ``{'x': [B,H,W,C]}`` or
            the array, uint8 or float, on the host or the device
        :param model: 'v1' (IS + FID) or 'ms_ssim'
        :param generator: the z stream's generator on ``self.device`` (JAX
            takes ``PRNGKey(1000 + chunk)``; the CLI seeds this so); every
            generated stream restarts from its state at the call
        :param classifier: replaces the default ``InceptionClassifier``
        :param seconds: filled with the time of each part (see
            ``GenerativeModelMetric``)
        """
        from mmdgan_torch.metrics.scores import GenerativeModelMetric

        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        start_state = generator.get_state()

        def gen_stream():
            g = torch.Generator(self.device)
            g.set_state(start_state)
            while True:
                yield self.generate(params, state, g, batch_size)

        def real_stream():
            for b in real_batches:
                x = b["x"] if isinstance(b, dict) else b
                yield decode_image_batch({"x": torch.as_tensor(x, device=self.device)})["x"]

        if model == "v1":
            metric = GenerativeModelMetric(classifier, model="v1", model_path=model_path,
                                           device=self.device)
            return metric.inception_score_and_fid(real_stream(), gen_stream(),
                                                  num_batch=num_batch, seconds=seconds)
        if model == "ms_ssim":
            # pairs within the real and within the generated batches
            # (my_sngan.py:637-645). As in JAX: the two real streams share
            # one iterator, so x takes the first halves of batches 0, 2, 4,
            # ... and y the second halves of 1, 3, 5, ...; each generated
            # stream restarts the generator, so both halves of a pair come
            # from the same batch.
            def halves(stream):
                for b in stream:
                    yield b[: len(b) // 2], b[len(b) // 2:]

            score = GenerativeModelMetric.ms_ssim_score
            score_data = score((a for a, _ in halves(real_stream())),
                               (b for _, b in halves(real_stream())), num_batch=num_batch)
            score_gen = score((a for a, _ in halves(gen_stream())),
                              (b for _, b in halves(gen_stream())), num_batch=num_batch)
            return score_data, score_gen
        raise NotImplementedError(f"Model {model} not implemented.")
