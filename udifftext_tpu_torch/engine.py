"""DiffusionEngine (port of `udifftext_tpu/engine.py`): the training loss
and sampling.

`loss` is the fine-tuning objective: the VAE latent of the image noised at
a sampled sigma, denoised by the UNet under the conditioning (with label
dropout), scored by the weighted diffusion loss plus the local attention
loss on the t_attn maps and, with `ocr_enabled`, the OCR loss: the denoised
latent decoded by the VAE and its bbox crop read by the frozen PARSeq. The
encodes and the LabelEncoder run without autograd; the decode and PARSeq run
under it (their parameters frozen), so the OCR term's gradient reaches the
UNet.

`sample` runs the inference path of test.py / demo.py: conditioning (label
embedding, mask rescale, VAE encode of the masked image, or the graph's
GeneralConditioner: its `vector` output goes to the UNet as y), the init-noise
search (candidates scored by the min-local attention loss after a 2-step
rollout), the CFG Euler-EDM loop (or, with `encprop_interval` > 1, its
approximate encoder-propagation form) and the VAE decode. With `aae_enabled`,
attend-and-excite descends the latent on the min-local loss through the
unguided UNet before each step; with `detailed`, the middle step's t_attn
maps are returned. `log_images` is a training run's image log: inputs, VAE
reconstructions and fresh samples.

Noise is injectable: every random draw of `loss` and `sample` may be given
explicitly; otherwise it is drawn from `generator` in the order each method
documents. This is how the port is held to the JAX engine, whose threefry
draws torch cannot reproduce.

Data parallelism (`sample(..., data_group=)`, `predict.Predictor`): each
process samples its own rows of a global batch, and the two choices that the
JAX package makes over the global batch read sums over the group: the
init-noise search's scores (one candidate for the whole batch) and
attend-and-excite's threshold test (every process iterates as often). Without
a group the engine makes no collective call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .conditioning import Conditioner, GeneralConditioner
from .diffusion import sampling as SP
from .diffusion.denoiser import Denoiser, DiscreteDenoiser
from .diffusion.guiders import VanillaCFG
from .diffusion.loss import FullLossConfig, full_loss, min_local_loss
from .diffusion.schedules import (
    Discretization,
    DiscreteSampling,
    LegacyDDPMDiscretization,
    append_dims,
)
from .models.label_encoder import LabelEncoder
from .models.parseq import PARSeq
from .models.unet import UNetModel
from .models.vae import AutoencoderKL, DiagonalGaussian
from .ocr import ParseqPredictor

Batch = Dict[str, torch.Tensor]

AAE_MAX_ITER = 20  # extra refinement iterations per enabled step


def group_sum(t: torch.Tensor, group: Any) -> torch.Tensor:
    """`t` summed over the processes of `group` (a new tensor)."""
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def aae_schedule(num_steps: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Attend-and-excite settings per sampling step (fp32 alphas, iteration
    flags, fp32 thresholds): step size 20·sqrt(1 − i/num_steps); the extra
    iterations run at steps 5, 9, …, 25 with thresholds −0.5 … −0.8."""
    scales = np.linspace(1.0, 0.0, num_steps + 1)
    alphas = (20.0 * np.sqrt(scales)[:-1]).astype(np.float32)
    iter_en = np.zeros(num_steps, bool)
    thres = np.zeros(num_steps, np.float32)
    thres_lst = np.linspace(-0.5, -0.8, 6)
    for pos, i in enumerate(np.linspace(5, 25, 6, dtype=np.int32)):
        if i < num_steps:
            iter_en[i] = True
            thres[i] = thres_lst[pos]
    return alphas, iter_en, thres


class DiffusionEngine(nn.Module):
    def __init__(
        self,
        unet: UNetModel,
        vae: AutoencoderKL,
        label_encoder: LabelEncoder,
        denoiser: Denoiser = DiscreteDenoiser(),
        discretization: Discretization = LegacyDDPMDiscretization(),
        sigma_sampler: DiscreteSampling = DiscreteSampling(),
        loss_cfg: FullLossConfig = FullLossConfig(),
        scale_factor: float = 0.18215,
        ucg_rate_label: float = 0.1,
        mask_multiplier: float = 0.125,
        latent_factor: int = 8,
        parseq: Optional[PARSeq] = None,
        general_conditioner: Optional[GeneralConditioner] = None,
    ):
        super().__init__()
        self.unet, self.vae, self.label_encoder = unet, vae, label_encoder
        # set for every embedder list but the shipped one, which the fused
        # `conditioner` runs
        self.general_conditioner = general_conditioner
        self.parseq = parseq  # the OCR loss's recognizer (None without it)
        self.denoiser = denoiser
        self.discretization = discretization
        self.sigma_sampler = sigma_sampler
        self.loss_cfg = loss_cfg
        self.scale_factor = scale_factor
        self.ucg_rate_label = ucg_rate_label
        self.mask_multiplier = mask_multiplier
        self.latent_factor = latent_factor

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def conditioner(self) -> Conditioner:
        return Conditioner(self.label_encoder, self.vae, self.scale_factor, self.mask_multiplier,
                           self.ucg_rate_label)

    @property
    def ocr_predictor(self) -> Optional[ParseqPredictor]:
        return None if self.parseq is None else ParseqPredictor(self.parseq)

    def conditionings(self, batch: Batch, posterior_eps: Optional[torch.Tensor] = None,
                      force_uc_zero_label: bool = True):
        """(c, uc) of a batch for sampling: the label embedding (the
        outputs of the embedders reading label_ids) zeroed in uc under
        `force_uc_zero_label`, one posterior draw shared by both."""
        if self.general_conditioner is not None:
            return self.general_conditioner.get_unconditional_conditioning(
                batch, posterior_eps,
                force_uc_zero_keys=("label_ids",) if force_uc_zero_label else ())
        return self.conditioner.get_unconditional_conditioning(batch, posterior_eps,
                                                               force_uc_zero_label)

    def encode_first_stage(self, x: torch.Tensor,
                           posterior_eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scaled VAE latent of images x: a posterior sample for the given
        standard-normal `posterior_eps`, or the posterior mode for None."""
        post = DiagonalGaussian(self.vae.encode_moments(x))
        z = post.mode() if posterior_eps is None else post.sample(posterior_eps.to(post.mean.dtype))
        return self.scale_factor * z

    def loss(
        self,
        batch: Batch,
        generator: Optional[torch.Generator] = None,
        image_eps: Optional[torch.Tensor] = None,
        masked_eps: Optional[torch.Tensor] = None,
        ucg_keep=None,
        sigma_idx: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The fine-tuning loss of a batch (image, masked, mask, seg,
        seg_mask, label_ids; with the OCR term also r_bbox and
        parseq_label_ids) → (loss, {loss/diff_loss, loss/local_loss[,
        loss/ocr_loss], loss/full_loss}), differentiable in the UNet's
        parameters (and in those of the trainable conditioner embedders).

        The random draws, each (B, h, w, 4) standard normal with (h, w) the
        latent size unless said otherwise, are taken from the arguments or,
        when None, from `generator` in this order: image_eps (the image
        posterior), masked_eps (the masked image's posterior; a
        GeneralConditioner's LatentEncoders all take it), ucg_keep (the
        dropout keep masks: (B,) for the label, Conditioner.draw_ucg_keep; a
        GeneralConditioner's {(embedder, output): (B,)},
        GeneralConditioner.draw_ucg_keep), sigma_idx (B,) (indices into the
        ascending sigma table), noise (the diffusion noise)."""
        b, h, w = batch["image"].shape[:3]
        shape = (b, h // self.latent_factor, w // self.latent_factor, 4)
        dev = batch["image"].device
        gc = self.general_conditioner
        conditioner = self.conditioner if gc is None else gc
        if image_eps is None:
            image_eps = torch.randn(shape, generator=generator, device=dev)
        if masked_eps is None:
            masked_eps = torch.randn(shape, generator=generator, device=dev)
        if ucg_keep is None:
            ucg_keep = conditioner.draw_ucg_keep(b, generator, dev)
        if sigma_idx is None:
            sigma_idx = self.sigma_sampler.draw_idx(b, generator, dev)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=dev)
        with torch.no_grad():  # the VAE and the LabelEncoder are frozen
            x = self.encode_first_stage(batch["image"], image_eps)
            if gc is None:
                cond = conditioner(batch, masked_eps, ucg_keep=ucg_keep)
        if gc is not None:  # under autograd: trainable embedders get their gradient
            cond = gc(batch, masked_eps, train=True, ucg_keep=ucg_keep)
        ocr_loss_fn = None
        predictor = self.ocr_predictor
        if self.loss_cfg.ocr_enabled and predictor is not None:
            def ocr_loss_fn(model_output, b):
                # under autograd: the gradient goes through the frozen decoder
                # and recognizer to the denoised latent
                return predictor.calc_loss(self.decode_first_stage(model_output), b["r_bbox"],
                                           b["parseq_label_ids"])
        return full_loss(self.loss_cfg, self.denoiser, self.network(capture_attn=True), cond, x,
                         batch, self.sigma_sampler(sigma_idx), noise.to(x.dtype), ocr_loss_fn)

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor)

    def network(self, capture_attn: bool = False, ctx_kv=None, method=None) -> Callable:
        """The UNet with the conditioning's channel concat in front; `method`
        picks another UNet entry point taking no capture_attn
        (`unet.forward_cached` for encoder propagation). A tensor-parallel
        UNet's captured maps come back with each sharded layer's heads
        averaged over the tensor group (`TensorParallel.head_mean_maps`), so
        that the losses' head mean is the whole layer's."""

        def net(x: torch.Tensor, c_noise: torch.Tensor, cond: Dict[str, Any]):
            if "concat" in cond:
                x = torch.cat([x, cond["concat"].to(x.dtype)], dim=-1)
            tc, vc, y = cond.get("t_crossattn"), cond.get("v_crossattn"), cond.get("vector")
            if method is not None:
                return method(x, c_noise, tc, vc, y, ctx_kv=ctx_kv)
            out, maps = self.unet(x, c_noise, tc, vc, y, capture_attn=capture_attn, ctx_kv=ctx_kv)
            if capture_attn and self.unet.tp is not None:
                maps = self.unet.tp.head_mean_maps(maps)
            return out, maps

        return net

    def make_denoise_fn(self, c, uc, cfg_scale: float, capture_attn: bool = False):
        """CFG denoiser x, sigma → denoised (and, with capture_attn, the
        conditional half's t_attn maps). The doubled cond dict and its
        cross-attention K/V are computed once, outside the step loop."""
        guider = VanillaCFG(cfg_scale)
        c_in = guider.prepare_cond(c, uc)
        ctx_kv = self.unet.precompute_context_kv(c_in.get("t_crossattn"), c_in.get("v_crossattn"))
        network = self.network(capture_attn, ctx_kv)

        def denoise(x, sigma):
            d, aux = self.denoiser(network, torch.cat([x, x]), torch.cat([sigma, sigma]), c_in)
            if not capture_attn:
                return guider(d, sigma)
            return guider(d, sigma), {k: v[v.shape[0] // 2:] for k, v in aux.items()}

        return denoise

    def make_denoise_fns_encprop(self, c, uc, cfg_scale: float):
        """The (key, reuse) CFG denoiser pair of encoder-propagation sampling
        (`sampling.sample_euler_edm_encprop`): denoise_full(x, sigma) →
        (denoised, the UNet's CFG-doubled encoder skip stack);
        denoise_reuse(x, sigma, stack) → denoised from the middle and output
        blocks on that stack. The doubled cond dict and its cross-attention
        K/V are computed once."""
        guider = VanillaCFG(cfg_scale)
        c_in = guider.prepare_cond(c, uc)
        ctx_kv = self.unet.precompute_context_kv(c_in.get("t_crossattn"), c_in.get("v_crossattn"))
        net_full = self.network(ctx_kv=ctx_kv, method=self.unet.forward_cached)

        def denoise_full(x, sigma):
            d, hs = self.denoiser(net_full, torch.cat([x, x]), torch.cat([sigma, sigma]), c_in)
            return guider(d, sigma), hs

        def denoise_reuse(x, sigma, hs):
            def net(_x, c_noise, cond):
                return self.unet.decode_cached(hs, c_noise, cond.get("t_crossattn"),
                                               cond.get("v_crossattn"), cond.get("vector"),
                                               ctx_kv=ctx_kv), None

            d, _ = self.denoiser(net, torch.cat([x, x]), torch.cat([sigma, sigma]), c_in)
            return guider(d, sigma)

        return denoise_full, denoise_reuse

    def _rollout_loss(self, denoise, x, sigmas, mask, seg_mask) -> torch.Tensor:
        """Min-local loss (B,) of the last of two Euler steps from x."""
        kernel = torch.as_tensor(self.loss_cfg.kernel, device=x.device)
        n = x.shape[0]
        loss = None
        for i in range(2):
            sigma = sigmas[i].expand(n).to(x.dtype)
            denoised, aux = denoise(x, sigma)
            loss = min_local_loss(aux, mask, seg_mask, kernel, self.loss_cfg.min_attn_size)
            if i == 0:
                x = x + append_dims(sigmas[1] - sigma, x.ndim) * SP.to_d(x, sigma, denoised)
        return loss

    def get_init_noise(
        self, c, uc, batch: Batch, noise: torch.Tensor, cfg_scale: float = 5.0,
        candidate_batched: bool = False, data_group: Any = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Init-noise search over the candidates `noise` (K, B, h, w, 4):
        each is scored by the summed min-local loss of a 2-step rollout, and
        the lowest score wins (the first on ties). Returns (best (B, h, w, 4),
        scores (K,)).

        candidate_batched=True stacks the candidates on the batch axis: 2 UNet
        evals at batch K·B instead of 2·K at batch B, the same function.

        With a `data_group`, `noise` and the batch are this process's rows of
        a global batch: the scores are summed over the group before the
        choice, so every process takes the candidate the global batch would."""
        k, b = noise.shape[:2]
        sigmas = torch.as_tensor(self.discretization(2, do_append_zero=True), device=noise.device)
        mask, seg_mask = batch["mask"], batch["seg_mask"]
        if candidate_batched:
            def tile(t):
                return torch.cat([t] * k, dim=0)

            denoise = self.make_denoise_fn({n: tile(t) for n, t in c.items()},
                                           {n: tile(t) for n, t in uc.items()},
                                           cfg_scale, capture_attn=True)
            x = SP.init_latent(noise.reshape((k * b,) + noise.shape[2:]), sigmas)
            loss = self._rollout_loss(denoise, x, sigmas, tile(mask), tile(seg_mask))
            scores = loss.reshape(k, b).sum(dim=1)
        else:
            denoise = self.make_denoise_fn(c, uc, cfg_scale, capture_attn=True)
            scores = torch.stack([
                self._rollout_loss(denoise, SP.init_latent(noise[i], sigmas), sigmas, mask,
                                   seg_mask).sum() for i in range(k)])
        if data_group is not None:
            scores = group_sum(scores, data_group)
        return noise[torch.argmin(scores)], scores  # argmin: the first minimum

    def _aae_update(self, c, batch: Batch, x: torch.Tensor, sigma: torch.Tensor, alpha: float,
                    iter_enabled: bool, thres: float, ctx_kv,
                    data_group: Any = None) -> torch.Tensor:
        """Attend-and-excite: gradient descent of x on the summed min-local
        loss of the unguided UNet on `c` (whose cross-attention K/V the
        caller hoisted into `ctx_kv`). The UNet is fed RAW x, not the
        c_in-scaled input the denoiser would give it, as the reference does
        (the step sizes and thresholds assume that loss surface). One update
        always; then, where `iter_enabled`, more while the loss before the
        last update is above `thres`, at most AAE_MAX_ITER. Each extra
        iteration reads the loss on the host once; with a `data_group` that
        loss is summed over the group first, so that every process runs as
        many iterations as the global batch would."""
        network = self.network(capture_attn=True, ctx_kv=ctx_kv)
        kernel = torch.as_tensor(self.loss_cfg.kernel, device=x.device)
        sigma_q = self.denoiser.quantize_sigma(sigma)
        c_noise = self.denoiser.scale(append_dims(sigma_q, x.ndim))[3]
        c_noise = self.denoiser.quantize_c_noise(c_noise.reshape(sigma.shape))

        def step(xx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
            xx = xx.detach().requires_grad_(True)
            _, aux = network(xx, c_noise, c)
            val = min_local_loss(aux, batch["mask"], batch["seg_mask"], kernel,
                                 self.loss_cfg.min_attn_size).sum()
            (g,) = torch.autograd.grad(val, xx)
            return xx.detach() - alpha * g, val.detach()

        with torch.enable_grad():
            x, val = step(x)
            it = 1
            while iter_enabled and it <= AAE_MAX_ITER and (
                    val if data_group is None else group_sum(val, data_group)).item() > thres:
                x, val = step(x)
                it += 1
        return x

    def _attn_map_shapes(self, b: int, latent_hw: Tuple[int, int],
                         cond: Dict[str, torch.Tensor]) -> Dict[str, Tuple[int, ...]]:
        """Shapes of the t_attn maps the UNet captures, keyed as it keys them,
        for a batch of b latents of size latent_hw (rectangular allowed)."""
        l = cond["t_crossattn"].shape[1]
        tokens = {}
        h, w = latent_hw
        for level in range(len(self.unet.channel_mult)):
            tokens[2**level] = h * w
            h, w = h // 2, w // 2
        return {f"{prefix}.{j}.t_attn": (b, spec.heads, tokens[spec.ds], l)
                for prefix, _, specs in self.unet._blocks()
                for j, spec in enumerate(specs) if spec.kind == "attn"}

    def _sample_guided(self, c, uc, batch: Batch, x: torch.Tensor, sigmas: torch.Tensor,
                       cfg_scale: float, aae_enabled: bool, detailed: bool,
                       data_group: Any = None):
        """The Euler loop with attend-and-excite before each step and/or the
        middle step's conditional t_attn maps kept. Returns (x, the middle
        step's maps ({} unless detailed), per-step {"inter": sample 0's
        denoised latent (steps, h, w, 4), "local_loss": the conditional
        half's min-local loss (steps, B)} or None unless aae_enabled)."""
        n = sigmas.shape[0] - 1
        b = x.shape[0]
        denoise = self.make_denoise_fn(c, uc, cfg_scale, capture_attn=True)
        kernel = torch.as_tensor(self.loss_cfg.kernel, device=x.device)
        aae_kv = (self.unet.precompute_context_kv(c.get("t_crossattn"), c.get("v_crossattn"))
                  if aae_enabled else None)
        alphas, iter_en, thres = aae_schedule(n)
        mid = n // 2
        saved = ({k: torch.zeros(s, device=x.device)
                  for k, s in self._attn_map_shapes(b, tuple(x.shape[1:3]), c).items()}
                 if detailed else {})
        inters, losses = [], []
        for i in range(n):
            sigma = sigmas[i].expand(b).to(x.dtype)
            if aae_enabled:
                x = self._aae_update(c, batch, x, sigma, float(alphas[i]), bool(iter_en[i]),
                                     float(thres[i]), aae_kv, data_group)
            denoised, aux = denoise(x, sigma)
            if detailed and i == mid:
                for k in saved:
                    saved[k].copy_(aux[k])
            if aae_enabled:
                inters.append(denoised[0].float())
                losses.append(min_local_loss(aux, batch["mask"], batch["seg_mask"], kernel,
                                             self.loss_cfg.min_attn_size))
            x = x + append_dims(sigmas[i + 1] - sigma, x.ndim) * SP.to_d(x, sigma, denoised)
        per_step = ({"inter": torch.stack(inters), "local_loss": torch.stack(losses)}
                    if aae_enabled else None)
        return x, saved, per_step

    @torch.no_grad()
    def sample(
        self,
        batch: Batch,
        generator: Optional[torch.Generator] = None,
        num_steps: int = 50,
        cfg_scale: float = 5.0,
        noise_iters: int = 10,
        aae_enabled: bool = False,
        detailed: bool = False,
        noise_search_batched: bool = False,
        posterior_eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        return_latents: bool = False,
        latent_hw: Optional[Tuple[int, int]] = None,
        encprop_interval: int = 0,
        data_group: Any = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Text inpainting (test.py predict() semantics) → (images in [0, 1]
        (B, H, W, 3), aux). aux["noise_scores"] holds the search's scores;
        with detailed, aux also holds the middle step's t_attn maps (keyed by
        layer); with aae_enabled, aux["inters"] (steps, H, W, 3), sample 0's
        decoded denoised latent per step in [0, 1], and aux["local_losses"]
        (steps, B).

        latent_hw: the latent's (h, w), rectangular allowed; by default the
        masked image's size over the VAE's factor. posterior_eps: (B, h, w, 4)
        standard normal; noise: (max(noise_iters, 1), B, h, w, 4) standard
        normal.

        encprop_interval > 1 opts into APPROXIMATE encoder-propagation
        sampling of the steps (the full UNet every encprop_interval-th step
        only, `uniform_key_mask`); it is ignored under aae_enabled or
        detailed, which need every step's maps, and refused for a UNet with
        the ctrl block. The engine does not consult the quality gate: the
        entry points do (`Predictor` at construction).

        data_group: the batch is this process's rows of a global batch that
        the group's processes sample together (`predict.Predictor` slices it
        and gathers the results); the search and attend-and-excite read
        sums over the group."""
        if encprop_interval > 1 and not (aae_enabled or detailed):
            self.unet.refuse_ctrl()
        b, h, w = batch["masked"].shape[:3]
        if latent_hw is None:
            latent_hw = (h // self.latent_factor, w // self.latent_factor)
        shape = (b, int(latent_hw[0]), int(latent_hw[1]), 4)
        dev = self.device
        posterior_eps, noise = self.sample_draws(shape, generator, noise_iters, posterior_eps,
                                                 noise)
        if noise.shape[1:] != shape or noise.shape[0] != max(noise_iters, 1):
            raise ValueError(f"noise must be {(max(noise_iters, 1),) + shape}, "
                             f"got {tuple(noise.shape)}")

        c, uc = self.conditionings(batch, posterior_eps)
        aux: Dict[str, torch.Tensor] = {}
        if noise_iters > 0:
            x0, aux["noise_scores"] = self.get_init_noise(
                c, uc, batch, noise, cfg_scale, candidate_batched=noise_search_batched,
                data_group=data_group)
        else:
            x0 = noise[0]
        sigmas = torch.as_tensor(self.discretization(num_steps, do_append_zero=True), device=dev)
        x = SP.init_latent(x0, sigmas)
        if aae_enabled or detailed:
            z, maps, per_step = self._sample_guided(c, uc, batch, x, sigmas, cfg_scale,
                                                    aae_enabled, detailed, data_group)
            aux.update(maps)
            if per_step is not None:
                inters = torch.cat([self.decode_first_stage(f[None]) for f in per_step["inter"]])
                aux["inters"] = torch.clamp((inters + 1.0) / 2.0, 0.0, 1.0)
                aux["local_losses"] = per_step["local_loss"]
        elif encprop_interval > 1:
            z = SP.sample_euler_edm_encprop(*self.make_denoise_fns_encprop(c, uc, cfg_scale), x,
                                            sigmas, SP.uniform_key_mask(num_steps, encprop_interval))
        else:
            z = SP.sample_euler_edm(self.make_denoise_fn(c, uc, cfg_scale), x, sigmas)
        if return_latents:
            return z, aux
        img = self.decode_first_stage(z)
        return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0), aux

    def sample_draws(self, shape: Tuple[int, ...], generator: Optional[torch.Generator],
                     noise_iters: int, posterior_eps: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """`sample`'s draws for latents of `shape` (B, h, w, 4): the given
        ones, the others from `generator` in this order: posterior_eps
        (B, h, w, 4), noise (max(noise_iters, 1), B, h, w, 4)."""
        dev = self.device
        if posterior_eps is None:
            posterior_eps = torch.randn(shape, generator=generator, device=dev)
        if noise is None:
            noise = torch.randn((max(noise_iters, 1),) + tuple(shape), generator=generator,
                                device=dev)
        return posterior_eps, noise

    @torch.no_grad()
    def log_images(
        self,
        batch: Batch,
        generator: Optional[torch.Generator] = None,
        n: int = 8,
        sample: bool = True,
        num_steps: int = 50,
        cfg_scale: float = 5.0,
        image_eps: Optional[torch.Tensor] = None,
        posterior_eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """The training run's image log of the first n samples: {"inputs",
        "reconstructions" (the VAE's decode of a posterior sample of the
        image), "samples" (fresh samples with noise_iters=0, when `sample`)},
        each (n, H, W, 3) in [-1, 1]. The draws (image_eps, then the
        sample's posterior_eps and noise, as `sample` documents) come from
        the arguments or from `generator` in that order."""
        small = {k: v[:n] for k, v in batch.items()}
        x = small["image"]
        b, h, w = x.shape[:3]
        if image_eps is None:
            image_eps = torch.randn((b, h // self.latent_factor, w // self.latent_factor, 4),
                                    generator=generator, device=x.device)
        log = {"inputs": x,
               "reconstructions": self.decode_first_stage(self.encode_first_stage(x, image_eps))}
        if sample:
            imgs, _ = self.sample(small, generator, num_steps=num_steps, cfg_scale=cfg_scale,
                                  noise_iters=0, posterior_eps=posterior_eps, noise=noise)
            log["samples"] = imgs * 2.0 - 1.0
        return log
