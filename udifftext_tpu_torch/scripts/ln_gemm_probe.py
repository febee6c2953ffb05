"""Where a call of the LayerNorm→projection kernel's route "mma" spends its
time on the card (csrc/ln_gemm.cu `ln_gemm_mma_kernel`).

    python -m udifftext_tpu_torch.scripts.ln_gemm_probe [K=20]

Needs the card and nvcc. Builds csrc/ln_gemm.cu as it is and in variants,
one library each under the package's build directory (every nvcc started
together; removed at the end), and runs the same calls on
each through the C entry point with `ln_gemm_plan`'s plan, each timed as K
launches back to back between CUDA events (median of 5 runs):

  as is          the kernel
  no LayerNorm   the prologue's LayerNorm left out (products on the raw x)
  no store       the epilogue's TMA stores left out
  half weights   every other weight box left unloaded, its stage's old
                 contents read again: half the weight stream from L2
  stamps         the kernel with per-block clock64 stamps, reported as the
                 median over warpgroups of the SM clocks until: the x rows
                 arrived, the LayerNorm was done, the first column tile's
                 products were done, its store was issued, the last tile was
                 done; and a tile's products against their tensor-core time
                 (4 m64nNk16 products of 2·64·N·16 flops a 64-column step, at
                 989 TFLOP/s over 132 SMs at 1.83 GHz: N/2 clocks a product)

The variants other than "as is" compute wrong outputs; only their times are
read. Then the host: one cuTensorMapEncodeTiled, a wrapper call against its
C entry point alone (enqueue time of 200 calls), and the wrapper back to
back against the C entry alone at three shapes. `run` returns
{label: value}; every line names the card.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from ..ops import _build
from ..ops import ln_gemm as L
from ._timing import probe_device, time_ms

# (label, rows, C, F, n_w): the glue probe's q/k/v projections at B=32, the
# demo's CFG batch (B=2), the single-output test shape
SHAPES = (("ds1 B=32", 131072, 320, 320, 3), ("ds2 B=32", 32768, 640, 640, 3),
          ("ds1 B=2", 8192, 320, 320, 3), ("ds2 B=2", 2048, 640, 640, 3),
          ("(2,128,1280)->3840", 256, 1280, 3840, 1))

_STAMP = ("  if (wg_thread == 0) udt_probe_stamps[(blockIdx.x * 2 + wg) * 8 + {k}] = "
          "clock64();\n")
# variant → edits of csrc/ln_gemm.cu, each (text, replacement); every text
# occurs once in the source (tests/test_torch_glue.py holds that)
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "as is": [],
    "no LayerNorm": [
        ("  layer_norm_16_rows(x_wg, (wg_thread >> 5) * 16, C, scale, bias, eps);\n", ""),
    ],
    "no store": [
        ("  if (wg_thread == 0) {\n#pragma unroll\n    for (int p = 0;",
         "  if (wg_thread < 0) {\n#pragma unroll\n    for (int p = 0;"),
    ],
    "half weights": [
        ("          udt::tma::mbar_arrive_expect_tx(bars + 8 * s, kStageBytes);\n"
         "          udt::tma::load_2d(ring + s * kStageBytes, &maps.w[wi], kc * 64, col0, "
         "bars + 8 * s);\n",
         "          if (kc & 1) {\n            udt::tma::mbar_arrive(bars + 8 * s);\n"
         "          } else {\n            udt::tma::mbar_arrive_expect_tx(bars + 8 * s, "
         "kStageBytes);\n            udt::tma::load_2d(ring + s * kStageBytes, &maps.w[wi], "
         "kc * 64, col0, bars + 8 * s);\n          }\n"),
    ],
    "stamps": [
        ("namespace mm = udt::mma;\n",
         "namespace mm = udt::mma;\n__device__ long long udt_probe_stamps[8192 * 2 * 8];\n"),
        ("  udt::tma::mbar_wait(x_bar, 0);\n",
         _STAMP.format(k=0) + "  udt::tma::mbar_wait(x_bar, 0);\n" + _STAMP.format(k=1)),
        ("  mm::named_barrier(1 + wg, mm::kWarpgroup);\n\n  const uint32_t stage_wg",
         "  mm::named_barrier(1 + wg, mm::kWarpgroup);\n" + _STAMP.format(k=2)
         + "\n  const uint32_t stage_wg"),
        ("    mm::fence_accumulator(acc);\n",
         "    mm::fence_accumulator(acc);\n    if (i == 0) {\n  " + _STAMP.format(k=3) + "    }\n"),
        ("    store_tile<N>(acc, stage_wg, maps, wi, row0, col0, wg_thread, 1 + wg);\n  }\n",
         "    store_tile<N>(acc, stage_wg, maps, wi, row0, col0, wg_thread, 1 + wg);\n"
         "    if (i == 0) {\n  " + _STAMP.format(k=4) + "    }\n  }\n" + _STAMP.format(k=5)),
    ],
}
_APPENDIX = """
extern "C" int udt_probe_read_stamps(void* host, int n) {
  return cudaMemcpyFromSymbol(host, udt_probe_stamps, n * sizeof(long long));
}
"""
_ENCODE_BENCH = """
extern "C" int udt_probe_encode(const void* base, int n) {
  CUtensorMap map;
  int failed = 0;
  for (int i = 0; i < n; ++i)
    failed += udt::tma::encode_tile_map(&map, base, 32768, 640, 160) != cudaSuccess;
  return failed;
}
"""


def variant_source(name: str) -> str:
    """csrc/ln_gemm.cu with the edits of variant `name`."""
    src = (_build.CSRC / "ln_gemm.cu").read_text()
    for text, new in VARIANTS[name]:
        if src.count(text) != 1:
            raise RuntimeError(f"ln_gemm_probe: variant {name!r} no longer matches the source")
        src = src.replace(text, new)
    if name == "stamps":
        src += _APPENDIX
    return src + (_ENCODE_BENCH if name == "as is" else "")


def _build_all(workdir: Path) -> Dict[str, ctypes.CDLL]:
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, workdir / h.name)
    jobs = {}
    for i, name in enumerate(VARIANTS):
        src = workdir / f"variant{i}.cu"
        src.write_text(variant_source(name))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(src.with_suffix(".so")),
               str(src)]
        jobs[name] = (src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (src, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ln_gemm_probe: nvcc failed on variant {name!r}:\n{err}")
        libs[name] = ctypes.CDLL(str(src.with_suffix(".so")))
    return libs


def _entry(lib: ctypes.CDLL):
    fn = lib.udt_ln_gemm_mma
    fn.argtypes, fn.restype = L._MMA_ARGTYPES, ctypes.c_int
    return fn


def run(reps: int = 20, runs: int = 5, device: str = "cuda") -> Dict[str, float]:
    """Every measurement above; returns {label: ms, clocks or µs}."""
    dev = probe_device("ln_gemm_probe", device)
    if dev.type != "cuda":
        raise RuntimeError("ln_gemm_probe: the variants run only on the card")
    card = torch.cuda.get_device_name(dev)
    results: Dict[str, float] = {}
    gen = torch.Generator(dev).manual_seed(0)
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
    workdir = _build.BUILD_DIR / "ln_gemm_probe"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        libs = _build_all(workdir)
        for label, m, c, f, n_w in SHAPES:
            x = torch.randn(m, c, generator=gen, device=dev).bfloat16()
            scale, bias = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            ws = [(torch.randn(f, c, generator=gen, device=dev) * c**-0.5).bfloat16()
                  for _ in range(n_w)]
            outs = [torch.empty(m, f, dtype=torch.bfloat16, device=dev) for _ in ws]
            unused = [None] * (3 - n_w)
            plan = L.ln_gemm_plan(torch.bfloat16, m, c, f, n_w)
            args = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), *(w.data_ptr() for w in ws),
                    *unused, *(o.data_ptr() for o in outs), *unused, n_w, m, c, f, L.EPS,
                    plan.rows, plan.n, plan.group_tiles, plan.stages, stream)
            times = {}
            for name, lib in libs.items():
                fn = _entry(lib)
                times[name] = results[f"{label} {name} ms"] = time_ms(
                    lambda fn=fn: fn(*args), reps, runs, dev)
            print(f"[ln_gemm_probe] {label} (M={m}, C={c}, {n_w}x F={f}; {plan.rows} rows, "
                  f"{plan.n}-column tiles, {plan.group_tiles} a block, {plan.blocks} blocks) on "
                  f"{card}, ms back to back: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
            results.update(_stamps(libs["stamps"], args, label, plan, c, card))
            del x, ws, outs
            torch.cuda.empty_cache()
        results.update(_host(libs["as is"], dev, card, reps, runs))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return results


def _stamps(lib, args, label, plan, c, card) -> Dict[str, float]:
    """One launch of the stamped kernel; the per-phase clocks (medians)."""
    fn = _entry(lib)
    fn(*args)
    torch.cuda.synchronize()
    rg = plan.rows // 64
    n = plan.blocks * 2 * 8
    buf = (ctypes.c_longlong * n)()
    read = lib.udt_probe_read_stamps
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    if read(buf, n):
        raise RuntimeError("ln_gemm_probe: reading the stamps failed")
    rows = [buf[(blk * 2 + w) * 8:(blk * 2 + w) * 8 + 6] for blk in range(plan.blocks)
            for w in range(rg)]
    names = ("x rows arrived", "LayerNorm", "first tile's products", "first tile's store issued",
             "the other tiles")
    out = {f"{label} clocks {nm}": statistics.median(r[k + 1] - r[k] for r in rows)
           for k, nm in enumerate(names)}
    tiles = plan.group_tiles
    tensor = 4 * (plan.n // 2) * (c // 64) * rg  # a tile's tensor-core clocks, rg warpgroups
    per_tile = out[f"{label} clocks the other tiles"] / max(tiles - 1, 1)  # with its store
    out[f"{label} tile / tensor time"] = out[f"{label} clocks first tile's products"] / tensor
    print(f"[ln_gemm_probe] {label} stamps on {card}, SM clocks (median over warpgroups): "
          + ", ".join(f"{nm} {out[f'{label} clocks {nm}']:.0f}" for nm in names)
          + f"; a tile's products {out[f'{label} tile / tensor time']:.2f}× their tensor-core "
          f"time ({tensor} clocks)"
          + (f", a later tile with its store {per_tile / tensor:.2f}×" if tiles > 1 else ""),
          flush=True)
    return out


def _host(lib, dev, card, reps, runs) -> Dict[str, float]:
    """The host's time for a tensor-map encode and for a wrapper call."""
    out = {}
    enc = lib.udt_probe_encode
    enc.argtypes, enc.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    w = torch.zeros(640, 640, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    if enc(w.data_ptr(), 10000):
        raise RuntimeError("ln_gemm_probe: a tensor-map encode failed")
    out["encode us"] = (time.perf_counter() - t0) / 10000 * 1e6
    line = f"[ln_gemm_probe] host of {card}: one cuTensorMapEncodeTiled {out['encode us']:.2f} us"
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
    for m, c, f in ((256, 1280, 3840), (2048, 640, 1920), (8192, 320, 960)):
        x = torch.randn(m, c, device=dev).bfloat16()
        scale, bias = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        wt = (torch.randn(f, c, device=dev) * c**-0.5).bfloat16()
        o = torch.empty(m, f, dtype=torch.bfloat16, device=dev)
        plan = L.ln_gemm_plan(torch.bfloat16, m, c, f, 1)
        entry = _entry(lib)
        args = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), wt.data_ptr(), None, None,
                o.data_ptr(), None, None, 1, m, c, f, L.EPS, plan.rows, plan.n,
                plan.group_tiles, plan.stages, stream)
        calls = {"wrapper": lambda: L.ln_gemm(x, scale, bias, wt), "C entry": lambda: entry(*args)}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            out[f"({m}, {c})->{f} {name} enqueue us"] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            out[f"({m}, {c})->{f} {name} ms"] = time_ms(fn, reps, runs, dev)
        line += (f"; ({m}, {c}) -> {f}: wrapper enqueue "
                 f"{out[f'({m}, {c})->{f} wrapper enqueue us']:.1f} us, back to back "
                 f"{out[f'({m}, {c})->{f} wrapper ms']:.4f} ms; C entry alone "
                 f"{out[f'({m}, {c})->{f} C entry enqueue us']:.1f} us, "
                 f"{out[f'({m}, {c})->{f} C entry ms']:.4f} ms")
    print(line, flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("reps", nargs="?", type=int, default=20, metavar="K",
                   help="back-to-back launches per timed run")
    args = p.parse_args(argv)
    run(args.reps)


if __name__ == "__main__":
    main()
