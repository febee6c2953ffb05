"""Diffusion samplers (port of `udifftext_tpu/diffusion/sampling.py`), each a
Python loop over the steps: Euler-EDM with optional stochastic churn, Heun,
Euler-ancestral, DPM++(2S) ancestral, DPM++(2M), linear multistep, and
Euler-EDM with encoder propagation.

`sigmas` is the descending schedule with a trailing zero (a tensor on the
sampler's device); `denoise_fn(x, sigma_vec)` is the CFG-blended denoiser
with sigma_vec of shape (B,). Decisions the JAX build makes on the device
with `jnp.where` / `lax.cond` (the last step, a reuse step) are made here on
the host from a copy of the schedule, so a step that the JAX build computes
and then discards is skipped: Heun's correction and DPM++(2S)'s second eval
on the last step.

Noise: a stochastic sampler draws one standard-normal tensor the shape of x
at step i (only at the steps that use it) from `noise` when given (a
sequence indexed by step, or a callable `noise(i, shape)`), else from
`generator`. Tests inject the JAX build's own draws this way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .schedules import append_dims

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Noise = Union[Sequence[torch.Tensor], Callable[[int, Tuple[int, ...]], torch.Tensor]]


def init_latent(randn: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """x0 = randn·sqrt(1 + sigma_max²)."""
    return randn * torch.sqrt(1.0 + sigmas[0] ** 2)


def to_d(x: torch.Tensor, sigma: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    return (x - denoised) / append_dims(sigma, x.ndim)


def get_ancestral_step(sigma_from: torch.Tensor, sigma_to: torch.Tensor,
                       eta: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma_down, sigma_up) of an ancestral step from sigma_from to sigma_to."""
    if not eta:
        return sigma_to, torch.zeros_like(sigma_to)
    sigma_up = torch.minimum(
        sigma_to, eta * torch.sqrt(sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2))
    return torch.sqrt(sigma_to**2 - sigma_up**2), sigma_up


@dataclasses.dataclass(frozen=True)
class EDMStochasticParams:
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0


def _gamma_for_step(sigma: float, num_sigmas: int, s_churn: float, s_tmin: float,
                    s_tmax: float) -> float:
    """The churn factor of a step at `sigma`: min(s_churn / steps, √2 − 1)
    inside [s_tmin, s_tmax], else 0; fp32 values, compared in fp32 as in
    the JAX build."""
    gamma = min(s_churn / (num_sigmas - 1), 2**0.5 - 1) if s_churn > 0 else 0.0
    sigma = np.float32(sigma)
    return float(np.float32(gamma)) if np.float32(s_tmin) <= sigma <= np.float32(s_tmax) else 0.0


def _draw(noise: Optional[Noise], generator: Optional[torch.Generator], i: int,
          x: torch.Tensor) -> torch.Tensor:
    """Step i's standard-normal tensor the shape of x."""
    if noise is None:
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    eps = noise(i, tuple(x.shape)) if callable(noise) else noise[i]
    return eps.to(device=x.device, dtype=x.dtype)


def _maybe_churn(x: torch.Tensor, sigma: torch.Tensor, gamma: float, eps: Optional[torch.Tensor],
                 s_noise: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x raised to sigma_hat = sigma·(1 + gamma) with noise eps, sigma_hat)."""
    sigma_hat = sigma * float(np.float32(gamma) + np.float32(1.0))
    if eps is not None:
        extra = torch.sqrt(torch.clamp(sigma_hat**2 - sigma**2, min=0.0))
        x = x + eps * s_noise * append_dims(extra, x.ndim)
    return x, sigma_hat


def _host(sigmas: torch.Tensor) -> torch.Tensor:
    """The schedule on the host (one copy a sampling call), for the loop's
    decisions."""
    return sigmas.detach().to("cpu", torch.float32)


def _vec(sigmas: torch.Tensor, i: int, x: torch.Tensor) -> torch.Tensor:
    return sigmas[i].expand(x.shape[0]).to(x.dtype)


def _edm_loop(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor, heun: bool,
              params: EDMStochasticParams, generator: Optional[torch.Generator],
              noise: Optional[Noise]) -> torch.Tensor:
    n = sigmas.shape[0]
    churn = params.s_churn > 0 and (generator is not None or noise is not None)
    # the exact Euler loop reads nothing back from the device
    host = _host(sigmas) if churn or heun else None
    for i in range(n - 1):
        sigma, next_sigma = _vec(sigmas, i, x), _vec(sigmas, i + 1, x)
        if churn:
            gamma = _gamma_for_step(float(host[i]), n, params.s_churn, params.s_tmin,
                                    params.s_tmax)
            # a step out of [s_tmin, s_tmax] adds zero noise: it is not drawn
            eps = _draw(noise, generator, i, x) if gamma > 0 else None
            x, sigma_hat = _maybe_churn(x, sigma, gamma, eps, params.s_noise)
        else:
            sigma_hat = sigma
        d = to_d(x, sigma_hat, denoise_fn(x, sigma_hat))
        dt = append_dims(next_sigma - sigma_hat, x.ndim)
        euler = x + dt * d
        if heun and float(host[i + 1]) >= 1e-14:  # no correction into sigma 0
            d2 = to_d(euler, next_sigma, denoise_fn(euler, next_sigma))
            x = x + dt * (d + d2) / 2.0
        else:
            x = euler
    return x


def sample_euler_edm(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor,
                     params: EDMStochasticParams = EDMStochasticParams(),
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Noise] = None) -> torch.Tensor:
    """Euler EDM loop. With params.s_churn > 0 and a noise source (generator
    or noise), each step with sigma in [s_tmin, s_tmax] first raises x to
    sigma·(1 + gamma) with fresh noise (the JAX build churns only when given
    an rng, likewise)."""
    return _edm_loop(denoise_fn, x, sigmas, False, params, generator, noise)


def sample_heun_edm(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor,
                    params: EDMStochasticParams = EDMStochasticParams(),
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Noise] = None) -> torch.Tensor:
    """Heun: the Euler step corrected by a second eval at the next sigma,
    except into sigma 0 (2·steps − 1 evals); churn as `sample_euler_edm`."""
    return _edm_loop(denoise_fn, x, sigmas, True, params, generator, noise)


def uniform_key_mask(num_steps: int, interval: int) -> np.ndarray:
    """Key-step mask for encoder propagation: every `interval`-th step runs
    the full UNet (True); the rest reuse the cached encoder features. Step 0
    is always key (there is no cache to reuse yet)."""
    mask = np.zeros((num_steps,), bool)
    mask[::max(interval, 1)] = True
    mask[0] = True
    return mask


def sample_euler_edm_encprop(
    denoise_full: Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, Any]],
    denoise_reuse: Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor],
    x: torch.Tensor,
    sigmas: torch.Tensor,
    key_mask: Sequence[bool],
) -> torch.Tensor:
    """Euler-EDM loop with encoder-feature propagation ("Faster Diffusion",
    arXiv 2312.09608): on a key step `denoise_full(x, sigma) -> (denoised,
    cache)` runs the whole UNet and keeps its encoder skip stack; on the
    others `denoise_reuse(x, sigma, cache)` replays the cached stack through
    the middle and output blocks with the current timestep.

    APPROXIMATE: an opt-in acceleration, not the reference sampler; it
    equals `sample_euler_edm` only when every step is key. `key_mask` is a
    host mask with one entry a step (a wrong length raises); step 0 is
    always key."""
    n = sigmas.shape[0] - 1
    mask = np.asarray(key_mask, dtype=bool).copy()
    if mask.shape != (n,):
        raise ValueError(f"key_mask has {mask.shape[0] if mask.ndim else 0} entries for "
                         f"{n} steps")
    mask[0] = True
    cache = None
    for i in range(n):
        sigma, next_sigma = _vec(sigmas, i, x), _vec(sigmas, i + 1, x)
        if mask[i]:
            denoised, cache = denoise_full(x, sigma)
        else:
            denoised = denoise_reuse(x, sigma, cache)
        x = x + append_dims(next_sigma - sigma, x.ndim) * to_d(x, sigma, denoised)
    return x


def sample_euler_ancestral(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[Noise] = None, eta: float = 1.0,
                           s_noise: float = 1.0) -> torch.Tensor:
    """Euler ancestral: an Euler step down to sigma_down, then noise of
    sigma_up added (not into sigma 0)."""
    host = _host(sigmas)
    for i in range(host.shape[0] - 1):
        sigma, next_sigma = _vec(sigmas, i, x), _vec(sigmas, i + 1, x)
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta)
        d = to_d(x, sigma, denoise_fn(x, sigma))
        x = x + append_dims(sigma_down - sigma, x.ndim) * d
        if float(host[i + 1]) > 0.0:
            x = x + _draw(noise, generator, i, x) * s_noise * append_dims(sigma_up, x.ndim)
    return x


def _to_neg_log_sigma(sigma: torch.Tensor) -> torch.Tensor:
    return -torch.log(sigma)


def _to_sigma(neg_log_sigma: torch.Tensor) -> torch.Tensor:
    return torch.exp(-neg_log_sigma)


def sample_dpmpp2s_ancestral(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[Noise] = None, eta: float = 1.0,
                             s_noise: float = 1.0) -> torch.Tensor:
    """DPM++(2S) ancestral: a second-order step (two evals) down to
    sigma_down, an Euler step where sigma_down is 0, then noise of sigma_up
    (not into sigma 0)."""
    host = _host(sigmas)
    for i in range(host.shape[0] - 1):
        sigma, next_sigma = _vec(sigmas, i, x), _vec(sigmas, i + 1, x)
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta)
        denoised = denoise_fn(x, sigma)
        # the same fp32 arithmetic on the host copy decides the branch
        if float(get_ancestral_step(host[i], host[i + 1], eta)[0]) > 0.0:
            t = _to_neg_log_sigma(sigma)
            t_next = _to_neg_log_sigma(torch.clamp(sigma_down, min=1e-10))
            h = t_next - t
            s = t + 0.5 * h
            x2 = (append_dims(_to_sigma(s) / _to_sigma(t), x.ndim) * x
                  - append_dims(torch.expm1(-0.5 * h), x.ndim) * denoised)
            denoised2 = denoise_fn(x2, _to_sigma(s))
            x = (append_dims(_to_sigma(t_next) / _to_sigma(t), x.ndim) * x
                 - append_dims(torch.expm1(-h), x.ndim) * denoised2)
        else:
            x = x + append_dims(sigma_down - sigma, x.ndim) * to_d(x, sigma, denoised)
        if float(host[i + 1]) > 0.0:
            x = x + _draw(noise, generator, i, x) * s_noise * append_dims(sigma_up, x.ndim)
    return x


def sample_dpmpp2m(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """DPM++(2M) multistep: first-order on the first and last steps, else
    the previous step's denoised output extrapolated."""
    host = _host(sigmas)
    n = host.shape[0]
    old_denoised = None
    for i in range(n - 1):
        sigma, next_sigma = _vec(sigmas, i, x), _vec(sigmas, i + 1, x)
        denoised = denoise_fn(x, sigma)
        t = _to_neg_log_sigma(sigma)
        t_next = _to_neg_log_sigma(torch.clamp(next_sigma, min=1e-10))
        h = t_next - t
        mult1 = append_dims(_to_sigma(t_next) / _to_sigma(t), x.ndim)
        mult2 = append_dims(torch.expm1(-h), x.ndim)
        if i == 0 or float(host[i + 1]) < 1e-14:
            x_new = mult1 * x - mult2 * denoised
        else:
            r = (t - _to_neg_log_sigma(_vec(sigmas, i - 1, x))) / h
            denoised_d = (append_dims(1 + 1 / (2 * r), x.ndim) * denoised
                          - append_dims(1 / (2 * r), x.ndim) * old_denoised)
            x_new = mult1 * x - mult2 * denoised_d
        x, old_denoised = x_new, denoised
    return x


def sample_lms(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor,
               order: int = 4) -> torch.Tensor:
    """Linear multistep: the last `order` derivatives weighted by quadrature
    integrals over the host's schedule."""
    from scipy import integrate

    sigmas_np = _host(sigmas).numpy()

    def lms_coeff(order, t, i, j):
        def fn(tau):
            prod = 1.0
            for k in range(order):
                if j != k:
                    prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
            return prod

        return integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]

    ds = []
    for i in range(len(sigmas_np) - 1):
        sigma = _vec(sigmas, i, x)
        ds.append(to_d(x, sigma, denoise_fn(x, sigma)))
        if len(ds) > order:
            ds.pop(0)
        cur_order = min(i + 1, order)
        coeffs = [lms_coeff(cur_order, sigmas_np, i, j) for j in range(cur_order)]
        x = x + sum(c * d for c, d in zip(coeffs, reversed(ds)))
    return x


SAMPLERS = {
    "euler_edm": sample_euler_edm,
    "heun_edm": sample_heun_edm,
    "euler_ancestral": sample_euler_ancestral,
    "dpmpp2s_ancestral": sample_dpmpp2s_ancestral,
    "dpmpp2m": sample_dpmpp2m,
    "lms": sample_lms,
}
