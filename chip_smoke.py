"""GPU smoke test of the PyTorch/CUDA port (udifftext_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a), nvcc, and the repository checkout; imports
torch, numpy and the port only (no JAX, PyYAML, Pillow or OpenCV). Phases,
each printed on its own line:

1. the card's name and power limit, as nvidia-smi prints them;
2. the kernel build from udifftext_tpu_torch/csrc, with its time;
3. each forward kernel against its plain PyTorch version on the same CUDA
   tensors, at the main path's shapes: max error against the stated
   tolerance and both times (CUDA events, median of repeated runs);
3b. the flash backward kernel against its plain version at the training
   and attend-and-excite shapes and in fp32: max error of dq, dk, dv each
   against a tolerance scaled to that gradient's magnitude, and both times;
4. one full-width SpatialTransformer at ds1 (320 channels, 64² latent) in
   bf16 on the GPU against the same block in fp32 on the CPU;
4b. that block's gradients (input, t_attn/t_norm weights), bf16 GPU with
   fp32 master weights against fp32 CPU;
5. the demo flow at full width (configs/test/textdesign_sd_2.yaml, held in
   builders.TEXTDESIGN_SD_2) with seeded random weights: a synthetic 512²
   image, a mask and the text "HELLO"; 10 candidates in the batched
   init-noise search, 50 steps, CFG 4.0. It checks the output and that the
   kernels served every flash/GEGLU call of the path;
6. the fine-tuning step at full width (configs/train/textdesign_sd_2.yaml,
   held in builders.TEXTDESIGN_SD_2_TRAIN, seeded random weights;
   configs/train.yaml's batch_size 16 and accumulate_grad_batches 4) on
   synthetic seg-capable 512² batches for 3 optimizer steps: finite loss
   components, frozen parameters bit-identical, trainable ones moved, no
   frozen gradient allocated, launch counts as the layer plan predicts;
   s per step, samples/s, peak device memory, the VAE encodes' share;
7. the demo flow of phase 5 with attend-and-excite and map capture
   (aae_enabled, detailed): output, local losses, middle-step maps, and
   flash-backward launches; s/sample.

Each path (demo, AAE, training) runs with the launch counts set to 0 just
before it and read just after. Any failure exits non-zero. The
second-to-last line is the kernels' JSON record: each kernel's `launches`
counts the training path (named by `launches_path`), `launches_by_path`
holds every path's count. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of `fn` on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_tol(ref) -> float:
    """Two bf16 ulps of the largest reference value: one rounding of the
    kernel's output, with the plain version's own output rounding."""
    return 2**-7 * max(1.0, float(ref.float().abs().max()))


def grad_tol(ref) -> float:
    """Two bf16 ulps of the gradient's largest entry (bf16; one rounding of
    each gradient, both sides computing in fp32), 1e-5 of it in fp32."""
    import torch

    return (2**-7 if ref.dtype == torch.bfloat16 else 1e-5) * float(ref.float().abs().max())


def rel_l2(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).norm() / want.norm())


def counts(*fns) -> dict:
    return {f.__name__: f.launches for f in fns}


def reset(*fns) -> None:
    for f in fns:
        f.launches = 0


class SyntheticBatches:
    """Seg-capable training micro-batches made from a seed: a smooth image
    with noise in [-1, 1], a text box mask, one segmentation channel per
    character (a column of the box), label ids of a random word."""

    def __init__(self, n: int, b: int, size: int = 512, seq: int = 12, seed: int = 0):
        import numpy as np

        from udifftext_tpu_torch.charset import encode_labels

        rs = np.random.RandomState(seed)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        self.batches = []
        for _ in range(n):
            image = np.empty((b, size, size, 3), np.float32)
            mask = np.zeros((b, size, size, 1), np.float32)
            seg = np.zeros((b, size, size, seq), np.float32)
            seg_mask = np.zeros((b, seq), np.float32)
            words = []
            for i in range(b):
                f = rs.uniform(1, 4, 3)
                image[i] = np.sin(np.stack([xx * f[0], yy * f[1], (xx + yy) * f[2]], -1) * 3)
                n_chars = rs.randint(2, seq + 1)
                y0, x0 = rs.randint(0, size // 2, 2)
                h, w = rs.randint(size // 8, size // 3), n_chars * rs.randint(8, size // (2 * seq))
                mask[i, y0:y0 + h, x0:x0 + w] = 1.0
                cw = w // n_chars
                for c in range(n_chars):
                    seg[i, y0:y0 + h, x0 + c * cw:x0 + (c + 1) * cw, c] = 1.0
                seg_mask[i, :n_chars] = 1.0
                words.append("".join(rs.choice(list("ABCDEFGHabcdefgh0123")) for _ in range(n_chars)))
            image = np.clip(image + 0.1 * rs.standard_normal(image.shape), -1, 1).astype(np.float32)
            self.batches.append({"image": image, "masked": image * (1 - mask), "mask": mask,
                                 "seg": seg, "seg_mask": seg_mask,
                                 "label_ids": encode_labels(words, seq)})

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the GPU")
    import numpy as np

    from udifftext_tpu_torch import demo
    from udifftext_tpu_torch.builders import (
        TEXTDESIGN_SD_2,
        TEXTDESIGN_SD_2_TRAIN,
        build_engine,
        randomize_parameters,
    )
    from udifftext_tpu_torch.models.attention import SpatialTransformer
    from udifftext_tpu_torch.models.layers import cast_weights
    from udifftext_tpu_torch.ops import _build
    from udifftext_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_ref,
    )
    from udifftext_tpu_torch.ops.geglu import geglu_ff, geglu_ff_ref
    from udifftext_tpu_torch.predict import Predictor
    from udifftext_tpu_torch.train import train

    kernel_fns = (flash_attention, flash_attention_bwd, geglu_ff)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"[torch] {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. the build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {_build.library_path().name} in {time.perf_counter() - t0:.2f} s")
    kernel = ""
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        m = re.search(r"entry function '\w*?((?:flash_fwd|flash_bwd_dq|flash_bwd_dkdv|geglu_wmma"
                      r"|geglu_simt|geglu_reduce)_kernel)(\w*)'", line)
        if m:
            kernel = m.group(1) + m.group(2).replace("__nv_bfloat16", "bf16")
        elif "spill stores" in line or "registers" in line:
            log(f"[ptxas] {kernel}: {line.split(':', 1)[-1].strip()}")

    # 3. kernels against their plain versions
    g = torch.Generator(dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    records = {}
    flash_cases = [  # (label, B, N, heads, dtype): ds1/ds2 self-attention
        ("ds1 B=2", 2, 4096, 5, torch.bfloat16), ("ds1 B=20", 20, 4096, 5, torch.bfloat16),
        ("ds2 B=2", 2, 1024, 10, torch.bfloat16), ("ds2 B=20", 20, 1024, 10, torch.bfloat16),
        ("ds2 B=2 fp32", 2, 1024, 10, torch.float32),
    ]
    for label, b, n, h, dtype in flash_cases:
        q, k, v = (randn(b, n, h, 64, dtype=dtype) for _ in range(3))
        out, lse = flash_attention(q, k, v)
        ref, ref_lse = flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        tol = bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5 * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v), reps=5)
        flops = 4 * b * h * n * n * 64
        log(f"[flash] {label}: max_abs_err {err:.3e} (tol {tol:.3e}), lse err {lse_err:.3e} "
            f"(tol 1e-4); kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.3f} ms")
        if not (err <= tol and lse_err <= 1e-4):
            fail(f"flash {label} disagrees with its plain version")
        records.setdefault("flash_attention", (label, err, ms, plain_ms))
        del q, k, v, out, ref, lse, ref_lse

    geglu_cases = [  # (label, rows, C, dtype): ds1/ds2/ds4 feed-forwards
        ("ds1 B=2", 2 * 4096, 320, torch.bfloat16), ("ds2 B=2", 2 * 1024, 640, torch.bfloat16),
        ("ds4 B=2", 2 * 256, 1280, torch.bfloat16), ("ds1 B=20", 20 * 4096, 320, torch.bfloat16),
        ("ds2 B=2 fp32", 2 * 1024, 640, torch.float32),
    ]
    for label, m, c, dtype in geglu_cases:
        x = randn(m, c, dtype=dtype)
        w1, b1 = randn(8 * c, c, dtype=dtype, scale=c**-0.5), randn(8 * c, dtype=dtype, scale=0.1)
        w2 = randn(c, 4 * c, dtype=dtype, scale=(4 * c) ** -0.5)
        b2 = randn(c, dtype=dtype, scale=0.1)
        out = geglu_ff(x, w1, b1, w2, b2)
        ref = geglu_ff_ref(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5 * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: geglu_ff(x, w1, b1, w2, b2))
        plain_ms = time_ms(lambda: geglu_ff_ref(x, w1, b1, w2, b2), reps=5)
        flops = 2 * m * 3 * c * 4 * c
        log(f"[geglu] {label} (M={m}, C={c}): max_abs_err {err:.3e} (tol {tol:.3e}); "
            f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms")
        if not err <= tol:
            fail(f"geglu {label} disagrees with its plain version")
        records.setdefault("geglu_ff", (label, err, ms, plain_ms))
        del x, w1, b1, w2, b2, out, ref

    # 3b. the flash backward kernel against its plain version
    bwd_cases = [  # (label, B, N, heads, dtype): training and AAE self-attention
        ("train ds1 B=16", 16, 4096, 5, torch.bfloat16),
        ("train ds2 B=16", 16, 1024, 10, torch.bfloat16),
        ("AAE ds1 B=1", 1, 4096, 5, torch.bfloat16),
        ("AAE ds2 B=1", 1, 1024, 10, torch.bfloat16),
        ("ds2 B=2 fp32", 2, 1024, 10, torch.float32),
    ]
    for label, b, n, h, dtype in bwd_cases:
        q, k, v, do = (randn(b, n, h, 64, dtype=dtype) for _ in range(4))
        out, lse = flash_attention(q, k, v)
        got = flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        want = flash_attention_bwd_ref(q, k, v, out, lse, do)
        errs = [float((g_.float() - w_.float()).abs().max()) for g_, w_ in zip(got, want)]
        tols = [grad_tol(w_) for w_ in want]
        del got, want
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do))
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do), reps=3)
        flops = 10 * b * h * n * n * 64  # 5 products of N×N×d (the TPU kernel's count)
        log(f"[flash_bwd] {label}: max_abs_err dq/dk/dv "
            f"{' / '.join(f'{e:.3e}' for e in errs)} (tol {' / '.join(f'{t:.3e}' for t in tols)}); "
            f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms")
        if not all(e <= t for e, t in zip(errs, tols)):
            fail(f"flash backward {label} disagrees with its plain version")
        records.setdefault("flash_attention_bwd", (label, max(errs), ms, plain_ms))
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()

    # 4. one full-width ds1 transformer block, GPU bf16 against CPU fp32
    blk_cpu = randomize_parameters(SpatialTransformer(320, 5, 64, 1, 2048), 1).eval()
    blk_gpu = cast_weights(SpatialTransformer(320, 5, 64, 1, 2048), torch.bfloat16).to(dev).eval()
    blk_gpu.load_state_dict(blk_cpu.state_dict())
    rs = np.random.RandomState(0)
    xb = torch.from_numpy(rs.standard_normal((2, 64, 64, 320)).astype(np.float32))
    ctx = torch.from_numpy(rs.standard_normal((2, 12, 2048)).astype(np.float32))
    with torch.no_grad():
        want, wmaps = blk_cpu(xb, ctx, None, True)
        got, gmaps = blk_gpu(xb.to(dev, torch.bfloat16), ctx.to(dev, torch.bfloat16), None, True)
    got = got.float().cpu()
    rel = float((got - want).norm() / want.norm())
    map_err = float((gmaps[0].cpu() - wmaps[0]).abs().max())
    log(f"[block] ds1 SpatialTransformer bf16 GPU vs fp32 CPU: relative L2 err {rel:.3e} "
        f"(tol 2e-2), t_attn map max err {map_err:.3e} (tol 2e-2)")
    if not (torch.isfinite(got).all() and rel <= 2e-2 and map_err <= 2e-2):
        fail("the ds1 transformer block disagrees with its fp32 CPU run")

    # 4b. the block's gradients: bf16 on the GPU (fp32 t_attn/t_norm master
    # weights, the rest frozen, as in training) against fp32 on the CPU
    train_keys = ("t_attn", "t_norm")
    blk_gpu = cast_weights(SpatialTransformer(320, 5, 64, 1, 2048), torch.bfloat16,
                           keep_fp32=train_keys).to(dev)
    blk_gpu.load_state_dict(blk_cpu.state_dict())
    grads = {}
    for name, blk, x_in, c_in in (("cpu", blk_cpu, xb, ctx),
                                  ("gpu", blk_gpu, xb.to(dev, torch.bfloat16),
                                   ctx.to(dev, torch.bfloat16))):
        for pn, prm in blk.named_parameters():
            prm.requires_grad_(any(k in pn for k in train_keys))
        x_in = x_in.clone().requires_grad_(True)
        r_out = torch.from_numpy(np.random.RandomState(1).standard_normal((2, 64, 64, 320))
                                 .astype(np.float32)).to(x_in.device)
        r_map = torch.from_numpy(np.random.RandomState(2).standard_normal((2, 5, 4096, 12))
                                 .astype(np.float32)).to(x_in.device)
        flash_attention_bwd.launches = 0
        out, maps = blk(x_in, c_in, None, True)
        ((out.float() * r_out).sum() + (maps[0] * r_map).sum()).backward()
        grads[name] = {"input": x_in.grad,
                       **{pn: p.grad for pn, p in blk.named_parameters() if p.requires_grad}}
        if name == "gpu":
            torch.cuda.synchronize()
            bwd_launches = flash_attention_bwd.launches
    errs = {k: rel_l2(grads["gpu"][k], grads["cpu"][k]) for k in grads["cpu"]}
    worst = max(errs, key=errs.get)
    log(f"[block-grad] ds1 SpatialTransformer gradients bf16 GPU vs fp32 CPU: relative L2 "
        f"input {errs['input']:.3e}, worst of {len(errs) - 1} t_attn/t_norm weights "
        f"{errs[worst]:.3e} ({worst}) (tol 3e-2); flash backward launches {bwd_launches}")
    if not (all(e <= 3e-2 for e in errs.values()) and bwd_launches == 1
            and all(torch.isfinite(g_).all() for g_ in grads["gpu"].values())):
        fail("the ds1 transformer block's gradients disagree with its fp32 CPU run")
    del blk_cpu, blk_gpu, grads

    # 5. the demo flow at full width
    t0 = time.perf_counter()
    bundle = build_engine(TEXTDESIGN_SD_2, torch.bfloat16, dev)
    randomize_parameters(bundle.engine, 0)
    torch.cuda.synchronize()
    log(f"[demo] engine built with seeded random weights in {time.perf_counter() - t0:.2f} s")
    yy, xx = np.mgrid[0:600, 0:800]
    image = np.stack([(xx * 255 // 800), (yy * 255 // 600), ((xx + yy) % 256)], -1)
    image = (image + rs.randint(0, 32, image.shape)).clip(0, 255).astype(np.uint8)
    mask = np.zeros((600, 800), np.uint8)
    mask[220:380, 200:600] = 255
    batch = demo.build_batch(image, mask, "HELLO", 512, 512, 12)
    predictor = Predictor(bundle.engine, num_steps=50, cfg_scale=4.0, noise_iters=10,
                          noise_search_batched=True)
    by_path = {}
    seconds = []
    for run in range(2):
        reset(*kernel_fns)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, aux = predictor(batch, torch.Generator(dev).manual_seed(run))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = counts(*kernel_fns)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"[demo] run {run}: {seconds[-1]:.3f} s per sample (B=1, 512², 10 candidates, "
            f"50 steps, CFG 4.0), peak device memory {peak:.2f} GiB, launches {launches}, "
            f"search scores {[round(float(s), 4) for s in aux['noise_scores']]}")
        if tuple(images.shape) != (1, 512, 512, 3):
            fail(f"output shape {tuple(images.shape)}")
        if not (torch.isfinite(images).all() and float(images.min()) >= 0.0
                and float(images.max()) <= 1.0):
            fail("output is not finite in [0, 1]")
        evals = 2 + 50  # two batched search evals, then the 50 steps
        want = {"flash_attention": evals * 10, "flash_attention_bwd": 0, "geglu_ff": evals * 15}
        if launches != want:
            fail(f"kernel launches {launches}, expected {want} (ds1+ds2 self-attention; "
                 "ds1/ds2/ds4 feed-forwards; no backward when sampling)")
    by_path["demo"] = launches
    log(f"[demo] output mean {float(images.mean()):.4f} std {float(images.std()):.4f}")

    # 7. the demo flow with attend-and-excite and middle-step map capture
    # (run here, on phase 5's engine, so that phase 6 measures its own peak)
    predictor = Predictor(bundle.engine, num_steps=50, cfg_scale=4.0, noise_iters=10,
                          aae_enabled=True, detailed=True, noise_search_batched=True)
    reset(*kernel_fns)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images, aux = predictor(batch, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    aae_s = time.perf_counter() - t0
    launches = by_path["aae"] = counts(*kernel_fns)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    n_aae = launches["flash_attention_bwd"] // 10  # gradient evaluations of the UNet
    losses = aux["local_losses"].float()
    maps = {k: v for k, v in aux.items() if k.endswith("t_attn")}
    log(f"[aae] {aae_s:.3f} s per sample (B=1, 512², 10 candidates, 50 steps, CFG 4.0, "
        f"attend-and-excite + map capture), peak device memory {peak:.2f} GiB, {n_aae} AAE "
        f"gradient evaluations, launches {launches}; local losses first/middle/last "
        f"{float(losses[0].mean()):.4f} / {float(losses[25].mean()):.4f} / "
        f"{float(losses[-1].mean()):.4f}; {len(maps)} middle-step maps")
    if tuple(images.shape) != (1, 512, 512, 3) or not (
            torch.isfinite(images).all() and float(images.min()) >= 0.0
            and float(images.max()) <= 1.0):
        fail("AAE output is not a finite (1, 512, 512, 3) image in [0, 1]")
    if tuple(losses.shape) != (50, 1) or not torch.isfinite(losses).all():
        fail(f"AAE local losses {tuple(losses.shape)} not finite of shape (50, 1)")
    if len(maps) != 16 or not all(torch.isfinite(m).all() and m.abs().sum() > 0
                                   for m in maps.values()):
        fail(f"middle-step maps: {len(maps)} of 16 t_attn layers, or not finite and nonzero")
    if tuple(aux["inters"].shape) != (50, 512, 512, 3):
        fail(f"AAE intermediates {tuple(aux['inters'].shape)}")
    evals = 2 + 50 + n_aae
    if not (n_aae >= 50 and launches == {"flash_attention": evals * 10,
                                         "flash_attention_bwd": n_aae * 10,
                                         "geglu_ff": evals * 15}):
        fail(f"AAE launches {launches}: expected ≥ 50 gradient evaluations, each with 10 "
             "flash forwards and backwards and 15 GEGLU forwards, besides the 52 sampling evals")
    del bundle, predictor, images, aux, maps
    torch.cuda.empty_cache()

    # 6. the fine-tuning step at full width
    # one epoch of `accum` micro-batches is one optimizer step
    steps, accum, micro_b = 3, 4, 16  # configs/train.yaml: batch_size 16, accumulate 4
    t0 = time.perf_counter()
    bundle = build_engine(TEXTDESIGN_SD_2_TRAIN, torch.bfloat16, dev, train=True)
    engine = bundle.engine
    randomize_parameters(engine, 0)
    frozen = {n: p.detach().cpu().clone() for n, p in engine.named_parameters()
              if not p.requires_grad}
    trained = {n: p.detach().cpu().clone() for n, p in engine.named_parameters()
               if p.requires_grad}
    batches = SyntheticBatches(accum, micro_b, seed=0)
    log(f"[train] engine (bf16, fp32 master weights for {len(trained)} t_attn/t_norm "
        f"tensors, {sum(p.numel() for p in trained.values()) / 1e6:.1f} M parameters; "
        f"{len(frozen)} frozen tensors) and {len(batches)} synthetic micro-batches of {micro_b} "
        f"ready in {time.perf_counter() - t0:.2f} s; remat off")
    with tempfile.TemporaryDirectory(prefix="udt_train_") as log_dir:
        cfgs = {"batch_size": micro_b, "base_learning_rate": 5e-5, "log_dir": log_dir,
                "lightning": {"accumulate_grad_batches": accum, "max_epochs": steps}}
        reset(*kernel_fns)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train(cfgs, batches, bundle, seed=0, log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = by_path["train"] = counts(*kernel_fns)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        with open(f"{log_dir}/train_metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
    step_s = [b_["time"] - a_["time"] for a_, b_ in zip(rows, rows[1:])]
    log(f"[train] {steps} optimizer steps of {accum}×{micro_b} samples in {train_s:.3f} s; "
        f"s per step after the first {[round(x_, 3) for x_ in step_s]}, "
        f"{accum * micro_b / step_s[-1]:.2f} samples/s; peak device memory {peak:.2f} GiB; "
        f"launches {launches}")
    for row in rows:
        vals = {k: v for k, v in row.items() if k.startswith("loss")}
        if set(vals) != {"loss", "loss/diff_loss", "loss/local_loss", "loss/full_loss"} or not all(
                np.isfinite(v) for v in vals.values()):
            fail(f"loss components {vals}")
    if state.step != steps:
        fail(f"{state.step} optimizer steps, expected {steps}")
    changed = [n for n, p in engine.named_parameters()
               if not p.requires_grad and not torch.equal(p.detach().cpu(), frozen[n])]
    if changed or any(p.grad is not None for p in engine.parameters() if not p.requires_grad):
        fail(f"frozen parameters changed or got gradients: {changed[:5]}")
    still = [n for n, p in engine.named_parameters()
             if p.requires_grad and torch.equal(p.detach().cpu(), trained[n])]
    if still:
        fail(f"trainable parameters did not move: {still[:5]}")
    # per micro-batch: 10 flash self-attentions (ds1, ds2) and 15 GEGLU
    # feed-forwards forward; the backward reaches 9 of the flash layers
    # (input block 1's self-attention sits before every trainable
    # parameter)
    micro = steps * accum
    want = {"flash_attention": micro * 10, "flash_attention_bwd": micro * 9,
            "geglu_ff": micro * 15}
    if launches != want:
        fail(f"training launches {launches}, predicted {want}")
    mb = {k: torch.as_tensor(v).to(dev) for k, v in batches.batches[0].items()}
    eps = torch.zeros(micro_b, 64, 64, 4, device=dev)
    with torch.no_grad():
        enc_ms = time_ms(lambda: (engine.encode_first_stage(mb["image"], eps),
                                  engine.conditioner.encode_masked(mb["masked"], eps)), reps=3)
    log(f"[train] the two fp32 VAE encodes of a micro-batch of {micro_b}: {enc_ms:.1f} ms, "
        f"{accum * enc_ms / 1e3 / step_s[-1]:.3f} of a step")
    del engine, bundle, state, frozen, trained, batches, mb

    kernels = []
    for name, src, replaces, key in (
        ("flash_attention_fwd", "udifftext_tpu_torch/csrc/flash_attention.cu",
         "udifftext_tpu/ops/flash_attention.py:41", "flash_attention"),
        ("flash_attention_bwd", "udifftext_tpu_torch/csrc/flash_attention_bwd.cu",
         "udifftext_tpu/ops/flash_attention.py:181", "flash_attention_bwd"),
        ("geglu_ff", "udifftext_tpu_torch/csrc/geglu.cu", "udifftext_tpu/ops/geglu.py:105",
         "geglu_ff"),
    ):
        label, err, ms, plain_ms = records[key]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": by_path["train"][key], "launches_path": "train",
                        "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "shape": label,
                        "launches_by_path": {p_: c_[key] for p_, c_ in by_path.items()}})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
