"""GPU smoke test of the PyTorch/CUDA port (udifftext_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a), nvcc, and the repository checkout; imports
torch, numpy and the port only (no JAX, PyYAML, Pillow or OpenCV). Phases,
each printed on its own line:

1. the card's name and power limit, as nvidia-smi prints them;
2. the kernel build from udifftext_tpu_torch/csrc, with its time;
3. each kernel against its plain PyTorch version on the same CUDA tensors,
   at the main path's shapes: max error against the stated tolerance and
   both times (CUDA events, median of repeated runs);
4. one full-width SpatialTransformer at ds1 (320 channels, 64² latent) in
   bf16 on the GPU against the same block in fp32 on the CPU;
5. the demo flow at full width (configs/test/textdesign_sd_2.yaml, held in
   builders.TEXTDESIGN_SD_2) with seeded random weights: a synthetic 512²
   image, a mask and the text "HELLO"; 10 candidates in the batched
   init-noise search, 50 steps, CFG 4.0. It checks the output and that the
   kernels served every flash/GEGLU call of the path.

Any failure exits non-zero. The second-to-last line is the kernels' JSON
record, the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the GPU")
    import numpy as np

    from udifftext_tpu_torch import demo
    from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2, build_engine, randomize_parameters
    from udifftext_tpu_torch.models.attention import SpatialTransformer
    from udifftext_tpu_torch.models.layers import cast_weights
    from udifftext_tpu_torch.ops import _build
    from udifftext_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from udifftext_tpu_torch.ops.geglu import geglu_ff, geglu_ff_ref
    from udifftext_tpu_torch.predict import Predictor

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
        m = re.search(r"entry function '\w*?((?:flash_fwd|geglu_wmma|geglu_simt|geglu_reduce)"
                      r"_kernel)(\w*)'", line)
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
        records.setdefault("flash", (label, err, ms, plain_ms))
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
        records.setdefault("geglu", (label, err, ms, plain_ms))
        del x, w1, b1, w2, b2, out, ref

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
    del blk_cpu, blk_gpu

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
    launches = {}
    seconds = []
    for run in range(2):
        flash_attention.launches = geglu_ff.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, aux = predictor(batch, torch.Generator(dev).manual_seed(run))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {"flash": flash_attention.launches, "geglu": geglu_ff.launches}
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
        if launches != {"flash": evals * 10, "geglu": evals * 15}:
            fail(f"kernel launches {launches}, expected {evals * 10} flash and {evals * 15} "
                 "GEGLU (ds1+ds2 self-attention; ds1/ds2/ds4 feed-forwards)")
    log(f"[demo] output mean {float(images.mean()):.4f} std {float(images.std()):.4f}")

    kernels = []
    for name, src, replaces in (
        ("flash_attention_fwd", "udifftext_tpu_torch/csrc/flash_attention.cu",
         "udifftext_tpu/ops/flash_attention.py:41"),
        ("geglu_ff", "udifftext_tpu_torch/csrc/geglu.cu", "udifftext_tpu/ops/geglu.py:105"),
    ):
        label, err, ms, plain_ms = records[name.split("_")[0]]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name.split("_")[0]], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "shape": label})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
