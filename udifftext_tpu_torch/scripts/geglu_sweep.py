"""Launch-plan sweep of the GEGLU kernel's "mma" route (port of `scripts/geglu_sweep.py`).

    python -m udifftext_tpu_torch.scripts.geglu_sweep [K=20] [--runs N] [--device cpu]

At the ds1 feed-forward of the JAX script (CFG-doubled batch 32, N = 4096,
C = 320, I = 1280; bf16; seeded random weights and biases) it launches the C
entry `udt_geglu_ff` (csrc/geglu.cu) on route "mma" with every plan
(`GegluPlan`: rows a block × splits of the hidden dimension) that the entry
takes (`mma_plans`), where the JAX script swept block_n × chunk. The probe
calls the entry itself with each plan, as the JAX script patched
`_pick_chunk`; `geglu_ff` keeps `geglu_plan`'s choice, which the sweep marks
"shipped" and also times through the wrapper. Each plan's output is held to
`geglu_ff_ref` at the bf16 tolerance before it is timed: a plan that
disagrees is reported as failed (NaN), never as the best; a launch the entry
refuses raises. Beside
the plans: the plain composition `GEGLUFeedForward` runs off the kernel and
its two cuBLAS products alone. On the CPU each plan runs
`geglu_ff_tiled_ref` with its splits, the kernel's order in plain PyTorch.
Times: CUDA events around K back-to-back calls, divided by K, the median of
`runs` windows (on the CPU the host clock, not a device time). `run` returns
{label: ms}.
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops import geglu as G
from ._engine import SEED
from ._timing import Rows, card_line, nbytes, probe_device

H100_SMS = 132  # multiprocessors of an H100 SXM, for planning without a card
COMPOSITION = "plain composition (2 products around an eager gate)"
PRODUCTS = "its two cuBLAS products alone"
WRAPPER = "geglu_ff (the wrapper, shipped plan)"


def mma_plans(m: int, c: int, inner: int) -> List[G.GegluPlan]:
    """Every plan the "mma" route of `udt_geglu_ff` takes for M rows of width
    C and I hidden units, by csrc/geglu.cu's `dispatch_mma` and `launch_mma`:
    C / 64 = NT·G with NT <= 5 output tiles a warpgroup and G in (1, 2, 4)
    warpgroups (`MMA_TILES`); rows 64, or 128 with G = 1; a chunk of 128
    hidden units with G = 4, else 64, and I a multiple of chunk·splits; with
    G < 4 the splits are the CTAs of one cluster, at most 8, dividing the
    rows a block, summed on the chip in one launch; with G = 4 any split
    count, a second launch adding up splits·M·C fp32 partial sums."""
    if G.geglu_kernel_route(torch.bfloat16, c) != "mma":
        return []
    tiles = c // 64
    group = 4 if tiles > 10 else 2 if tiles > 5 else 1
    chunk = 128 if group == 4 else 64
    plans = []
    for rows in ((64, 128) if group == 1 else (64,)):
        for splits in range(1, inner // chunk + 1):
            if inner % (chunk * splits):
                continue
            if group < 4:
                if splits > 8 or rows % splits:
                    continue
                plans.append(G.GegluPlan("mma", rows, splits, 1, 0))
            else:
                plans.append(G.GegluPlan("mma", rows, splits, 1 + (splits > 1),
                                         splits * m * c * 4 if splits > 1 else 0))
    return plans


def launch(plan: G.GegluPlan, x, w1, b1, w2, b2) -> torch.Tensor:
    """One call of the C entry with `plan` (the launch `geglu_ff` makes with
    `geglu_plan`'s plan), counted in `launch.launches` (the wrapper's count
    leaves these out); for CPU tensors `geglu_ff_tiled_ref` with its
    splits."""
    c, inner = x.shape[-1], w2.shape[1]
    if not x.is_cuda:
        return G.geglu_ff_tiled_ref(x, w1, b1, w2, b2, splits=plan.splits,
                                    chunk=128 if c // 64 > 10 else 64)
    m = x.numel() // c
    out = torch.empty_like(x)
    partial = (torch.empty((plan.splits, m, c), dtype=torch.float32, device=x.device)
               if plan.partial_bytes else None)
    fn = _build.kernel_function("udt_geglu_ff", G._ARGTYPES)
    err = fn(x.data_ptr(), None, None, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             b2.data_ptr(), out.data_ptr(), None if partial is None else partial.data_ptr(),
             m, c, inner, plan.rows, plan.splits, G.EPS, _build.DTYPE_CODES[x.dtype],
             G.ROUTE_CODES["mma"], _build.stream_handle(x))
    _build.check(err, f"udt_geglu_ff (rows {plan.rows}, splits {plan.splits})")
    launch.launches += 1
    return out


launch.launches = 0


def plan_label(plan: G.GegluPlan, shipped: G.GegluPlan) -> str:
    mark = " (shipped)" if plan == shipped else ""
    return f"rows={plan.rows:3d} splits={plan.splits:2d}{mark}"


@torch.no_grad()
def run(reps: int = 20, runs: int = 3, device: str = "cuda", batch: int = 32,
        n: int = 4096, channels: int = 320) -> Dict[str, float]:
    """The sweep at (batch, n, channels) with I = 4·channels; returns
    {label: ms}, NaN for a plan that failed."""
    dev = probe_device("geglu_sweep", device)
    c, inner, m = channels, 4 * channels, batch * n
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" \
        else H100_SMS
    gen = torch.Generator(dev).manual_seed(SEED)

    def randn(*shape, scale):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    x = randn(batch, n, c, scale=1.0)
    w1, b1 = randn(2 * inner, c, scale=c**-0.5), randn(2 * inner, scale=0.02)
    w2, b2 = randn(c, inner, scale=inner**-0.5), randn(c, scale=0.02)
    flops = 2.0 * m * 3 * c * inner
    done = (flops, nbytes(x, w1, b1, w2, b2, x))
    shipped = G.geglu_plan(torch.bfloat16, m, c, inner, sms)
    plans = mma_plans(m, c, inner)
    print(f"== GEGLU plans: B={batch}, N={n}, C={c}, I={inner}, bf16, {sms} multiprocessors: "
          f"{flops / 1e9:.0f} GFLOP; shipped plan rows={shipped.rows} "
          f"splits={shipped.splits} ==\n{card_line(dev)}", flush=True)
    rows = Rows(dev, reps, runs, width=40)
    ref = G.geglu_ff_ref(x, w1, b1, w2, b2).float()
    tol = 2**-7 * max(1.0, float(ref.abs().max()))  # two bf16 ulps of the largest value
    for plan in plans:
        label = plan_label(plan, shipped)
        err = float((launch(plan, x, w1, b1, w2, b2).float() - ref).abs().max())
        if not err <= tol:
            rows.results[label] = float("nan")
            print(f"{label:40s} FAILED: max error {err:.3e} against the plain version "
                  f"(tol {tol:.3e})", flush=True)
            continue
        rows.time(label, lambda: launch(plan, x, w1, b1, w2, b2), done,
                  note=f"{plan.launches} launch(es), error {err:.2e}")
    rows.time(WRAPPER, lambda: G.geglu_ff(x, w1, b1, w2, b2), done)

    act = torch.empty(m, inner, dtype=x.dtype, device=dev)
    x2 = x.reshape(m, c)

    def composition():
        h, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
        return F.linear(h * F.gelu(gate), w2, b2)

    rows.time(COMPOSITION, composition, done)
    rows.time(PRODUCTS, lambda: (F.linear(x2, w1), F.linear(act, w2)), done)
    timed = {label: ms for label, ms in rows.results.items()
             if label.startswith("rows=") and ms == ms}
    if timed:
        best = min(timed, key=timed.get)
        ship = timed.get(plan_label(shipped, shipped), float("nan"))
        print(f"best plan: {best.strip()} at {timed[best]:.3f} ms "
              f"({flops / timed[best] / 1e9:.1f} TFLOP/s); the shipped plan {ship:.3f} ms",
              flush=True)
    return rows.results


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("reps", nargs="?", type=int, default=20, metavar="K",
                   help="back-to-back calls per timed window")
    p.add_argument("--runs", type=int, default=3, help="timed windows; the median is kept")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.reps, args.runs, args.device)


if __name__ == "__main__":
    main()
