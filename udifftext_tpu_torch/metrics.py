"""FID and LPIPS over saved real/fake image directories (port of the JAX
build's root metrics.py; the eval CLI's `quan_test`).

  - FID: `models.inception.FIDInceptionV3` (pytorch_fid's pool3 variant)
    with pytorch_fid's `pt_inception-2015-12-05` weights from
    $UDIFFTEXT_FID_WEIGHTS (default
    ./checkpoints/metrics/pt_inception-2015-12-05.pth), then the Frechet
    distance of the two feature sets' Gaussians (numpy/scipy).
  - LPIPS: `models.lpips.LPIPSAlex` with an `lpips.LPIPS(net='alex')` state
    dict from $UDIFFTEXT_LPIPS_WEIGHTS (default
    ./checkpoints/metrics/lpips_alex.pth), or lpips' lin-only file with
    torchvision's AlexNet weights from $UDIFFTEXT_ALEXNET_WEIGHTS (default
    ./checkpoints/metrics/alexnet.pth); the mean distance over the
    directories' image pairs in name order.

The variables are read when a function is called. Without weights the
functions print why they cannot run and return None rather than score
random features; a `feature_fn` / `distance_fn` override is always used
first. The networks run on the caller's `device` (the card by default).
Images are read with `utils/png.read_png` (the PNGs the eval CLI writes);
other files need Pillow.
"""

from __future__ import annotations

import glob
import os
from os.path import join as ospj
from typing import Callable, Optional

import numpy as np
import torch

from .utils.png import read_png

DEFAULT_FID_WEIGHTS = "./checkpoints/metrics/pt_inception-2015-12-05.pth"
DEFAULT_LPIPS_WEIGHTS = "./checkpoints/metrics/lpips_alex.pth"
DEFAULT_ALEXNET_WEIGHTS = "./checkpoints/metrics/alexnet.pth"


def fid_weights() -> str:
    return os.environ.get("UDIFFTEXT_FID_WEIGHTS", DEFAULT_FID_WEIGHTS)


def lpips_weights() -> str:
    return os.environ.get("UDIFFTEXT_LPIPS_WEIGHTS", DEFAULT_LPIPS_WEIGHTS)


def alexnet_weights() -> str:
    return os.environ.get("UDIFFTEXT_ALEXNET_WEIGHTS", DEFAULT_ALEXNET_WEIGHTS)


def read_rgb(path: str) -> np.ndarray:
    """An image file as float32 (H, W, 3) in [0, 1]: a PNG of
    `utils/png.write_png`'s kind through `read_png`, anything else through
    Pillow (converted to RGB), which must then be installed."""
    try:
        img = read_png(path)
    except ValueError as err:
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(f"{err}; reading other image files needs Pillow, which is not "
                             "installed") from err
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img.astype(np.float32) / 255.0


def load_inception_feature_fn(weights_path: Optional[str] = None,
                              device: torch.device | str = "cuda"):
    """(N, H, W, 3) [0, 1] numpy → (N, 2048) pool3 features (numpy), with
    FIDInceptionV3 on `device`; None if the weights file is absent."""
    from .models.inception import FIDInceptionV3, fid_inception_features
    from .utils.ckpt import load_state_dict

    path = weights_path or fid_weights()
    if not os.path.exists(path):
        return None
    with torch.device(device):
        model = FIDInceptionV3()
    model.load_state_dict(fid_inception_features(load_state_dict(path)), strict=True)
    model.requires_grad_(False).eval()

    @torch.no_grad()
    def features(x: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(np.asarray(x, np.float32)).to(device).permute(0, 3, 1, 2)
        return model(t).cpu().numpy()

    return features


def load_lpips_distance_fn(weights_path: Optional[str] = None,
                           alexnet_path: Optional[str] = None,
                           device: torch.device | str = "cuda"):
    """(H, W, 3) [0, 1] numpy pair → LPIPS distance (float), with LPIPSAlex
    on `device`; None if the weights are absent."""
    from .models.lpips import LPIPSAlex, lpips_alex_state_dict
    from .utils.ckpt import load_state_dict

    path = weights_path or lpips_weights()
    if not os.path.exists(path):
        return None
    sd = load_state_dict(path)
    alex_sd = None
    if not any(k.startswith("net.") for k in sd):
        apath = alexnet_path or alexnet_weights()
        if not os.path.exists(apath):
            print(f"LPIPS: {path} has only lin weights and {apath} is absent")
            return None
        alex_sd = load_state_dict(apath)
    with torch.device(device):
        model = LPIPSAlex()
    model.load_state_dict(lpips_alex_state_dict(sd, alex_sd), strict=True)
    model.requires_grad_(False).eval()

    def image(a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a, np.float32)).to(device)
        return t.permute(2, 0, 1)[None] * 2.0 - 1.0

    @torch.no_grad()
    def distance(a: np.ndarray, b: np.ndarray) -> float:
        return float(model(image(a), image(b))[0])

    return distance


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (Heusel et al. 2017). The JAX build's
    `sqrtm(..., disp=False)` is `sqrtm(...)` here: SciPy 1.18 removed `disp`,
    and the error estimate it returned was never read."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def activation_statistics(features: np.ndarray):
    """(N, D) features → (mu, sigma)."""
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def _image_paths(d: str) -> list:
    return sorted(glob.glob(ospj(d, "*")))


def calc_fid(fake_dir: str, real_dir: str,
             feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
             batch_size: int = 8, device: torch.device | str = "cuda") -> Optional[float]:
    """FID between two image directories. Images are fed at their own size
    (the extractor resizes with pytorch_fid's resampling), grouped by shape:
    a group goes through the extractor as soon as it holds `batch_size`
    images, so at most that many wait per distinct shape."""
    print(f"evaluating FID score between '{fake_dir}' and '{real_dir}'")
    if feature_fn is None:
        feature_fn = load_inception_feature_fn(device=device)
    if feature_fn is None:
        print("FID skipped: no feature extractor available — place pytorch_fid's "
              f"pt_inception-2015-12-05.pth at {fid_weights()} (or set "
              "UDIFFTEXT_FID_WEIGHTS), or pass feature_fn")
        return None

    def features_of(d):
        buckets, feats = {}, []
        for p in _image_paths(d):
            arr = read_rgb(p)
            pend = buckets.setdefault(arr.shape, [])
            pend.append(arr)
            if len(pend) == batch_size:
                feats.append(np.asarray(feature_fn(np.stack(pend))))
                pend.clear()
        for pend in buckets.values():
            if pend:
                feats.append(np.asarray(feature_fn(np.stack(pend))))
        return np.concatenate(feats, axis=0)

    mu1, s1 = activation_statistics(features_of(fake_dir))
    mu2, s2 = activation_statistics(features_of(real_dir))
    fid = frechet_distance(mu1, s1, mu2, s2)
    print(f"FID: {fid:.3f}")
    return fid


def calc_lpips(fake_dir: str, real_dir: str,
               distance_fn: Optional[Callable[[np.ndarray, np.ndarray], float]] = None,
               device: torch.device | str = "cuda") -> Optional[float]:
    """Mean LPIPS distance over the two directories' images, paired in name
    order."""
    print(f"evaluating LPIPS score between '{fake_dir}' and '{real_dir}'")
    if distance_fn is None:
        distance_fn = load_lpips_distance_fn(device=device)
    if distance_fn is None:
        print("LPIPS skipped: no distance function available — place an "
              f"lpips.LPIPS(net='alex') state-dict dump at {lpips_weights()} (or "
              "set UDIFFTEXT_LPIPS_WEIGHTS), or pass distance_fn")
        return None
    dists = [distance_fn(read_rgb(fp), read_rgb(rp))
             for fp, rp in zip(_image_paths(fake_dir), _image_paths(real_dir))]
    score = float(np.mean(dists)) if dists else float("nan")
    print(f"lpips score: {score}")
    return score
