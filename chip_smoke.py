"""GPU smoke test of the PyTorch/CUDA port (udifftext_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a), nvcc, and the repository checkout; imports
torch, numpy and the port only (no JAX, PyYAML, Pillow, OpenCV,
matplotlib, imageio or safetensors). Phases, each printed on its own line:

1. the card's name and power limit, as nvidia-smi prints them;
2. the kernel build from udifftext_tpu_torch/csrc, with its time and the
   compiler's register and spill report of every kernel; it fails if a
   tensor-core (`wgmma`) flash, GEGLU, flash-variant (each of the twelve
   instantiations of flash_variant_mma_kernel<BQ, BK, TR, CLAMP>), t_attn
   kernel (cross_attn_mma_kernel<RG>, 64 and 128 rows a block) or
   LN→projection kernel (the four ln_gemm_mma_kernel<N, RG>: 160- or
   64-column tiles, 64 or 128 rows a block) spills or had its wgmma
   pipeline serialized;
3. each forward kernel against its plain PyTorch version on the same CUDA
   tensors, at the main path's shapes: max error against the stated
   tolerance and both times (CUDA events, median of repeated runs); each
   flash case names the kernel route that served it ("mma": tensor cores,
   bf16 with d = 64; "fma": fp32, and bf16 with d = 128), each GEGLU case
   its route ("mma": `wgmma` with staged weights, bf16 with C % 64 == 0;
   "wmma"; "fma": fp32), its launch plan, its time when 20 calls are queued
   back to back, and the module's plain composition and that composition's
   two cuBLAS products alone as yardsticks beside the bound;
3b. the flash backward kernel against its plain version at the training
   and attend-and-excite shapes and in fp32: max error of dq, dk, dv each
   against a tolerance scaled to that gradient's magnitude, both times and
   the route;
3c. the four LayerNorm-fused kernels (ln_gemm, ln_gemm3, fused_cross_attention,
   geglu_ff_ln) against their plain versions on seeded random tensors at the
   ds1 and ds2 widths, B=2 and B=32, bf16, and one fp32 case each (ln_gemm
   also at (2, 128, 1280) → 3840), and the gradients of each autograd
   Function against the plain version's autograd; ln_gemm and ln_gemm3 name
   their route ("mma": `wgmma` with weights through a TMA ring fed by a
   producer warp, bf16 with C % 64 == 0, which every bf16 case at C = 320,
   640 and 1280 must take; "wmma"; "fma": fp32, which the fp32 case must
   take) and plan (rows a block, tile width, column tiles a block of all,
   blocks, ring stages and how often the busiest block wraps its ring), their
   time when 20 calls are queued back to back, the unfused composition the
   block runs with fuse_glue="off" (LayerNormF32, then one wide or three
   separate F.linear) and its cuBLAS products alone; two more cases hold
   them with F = 336 (ragged last tiles, column groups across the q/k
   boundary) and with a ring wrapped 10 times; fused_cross_attention
   names its route ("mma": `wgmma`, bf16 at the ds1/ds2 widths; "wmma";
   "fma": fp32) and rows a block, its time when 20 calls are queued back to
   back, and beside it the unfused composition the block runs with
   fuse_glue="off" and that composition's two cuBLAS products alone; two
   more cases hold it with L = 64 and with logits past exp's fp32 range
   (the max subtraction binding);
3d. the probe-level kernels against their plain versions: fused_groupnorm_silu
   at the ResBlock widths (bf16, fp32, without SiLU at eps 1e-6, and under a
   large common offset), with N = 4133 (a ragged last CTA) and at the VAE
   decoder's (1, 512, 512, 128) fp32, which must take route "two_pass" where
   every other case takes "cluster", each with its plan, its back-to-back
   time and the device launches a call counted by torch.profiler (1 on
   "cluster", 2 on "two_pass"), beside F.group_norm + F.silu; every flash variant
   (v1-v4) at every tile pair at B·H = 160 and 10, N = 4096 and 1024, with
   its route ("mma": `wgmma`, bf16; "fma": fp32) and registers, beside
   scaled_dot_product_attention, plus a case whose logits pass 80, where v1
   must follow the plain version clamped at ±75, v3/v4 the one clamped at
   ±60 and v2 the softmax, v1's log Σp within 1e-4 everywhere; and that both
   wrappers raise when a gradient is asked through them;
4. one full-width SpatialTransformer at ds1 (320 channels, 64² latent) in
   bf16 on the GPU against the same block in fp32 on the CPU;
4b. that block's gradients (input, t_attn/t_norm weights), bf16 GPU with
   fp32 master weights against fp32 CPU;
5. the demo flow at full width (configs/test/textdesign_sd_2.yaml, held in
   builders.TEXTDESIGN_SD_2) with seeded random weights: a synthetic 512²
   image, a mask and the text "HELLO"; 10 candidates in the batched
   init-noise search, 50 steps, CFG 4.0, four times (the spread is the
   host's). It checks the output and that the kernels served every
   flash/GEGLU call of the path; then one more sample under torch.profiler
   for the device time by kernel group (`[profile]`; likewise one optimizer
   step after phase 6 and an AAE run cut to 5 steps after phase 7);
5c. a checkpoint round trip at full width: phase 5's seeded engine saved
   under the reference prefixes as a .ckpt, and its VAE alone as a
   .safetensors file written here byte by byte; a freshly built engine
   (whose 110 zero-initialized UNet parameters must be zero) loads the VAE
   file as the graph's component checkpoint and the .ckpt as a run
   checkpoint (udifftext_tpu_torch.loading): no missing, unexpected or
   mismatched key, every parameter bit-equal; file sizes, seconds to save
   and to load, peak host RSS;
5b. the implementation switch: the engine built again with attn_impl="plain"
   on the same seeded weights: one UNet eval at the demo's shapes (B=2,
   bf16) under "auto" and under "plain", the kernel counters moving only in
   the first and the outputs agreeing in relative L2; then a 5-step sample
   under each, and under "auto" with only the feed-forwards forced plain,
   timed (`[plain_ab] kernels … s, plain … s, …`);
6. the fine-tuning step at full width (configs/train/textdesign_sd_2.yaml,
   held in builders.TEXTDESIGN_SD_2_TRAIN, seeded random weights;
   configs/train.yaml's batch_size 16 and accumulate_grad_batches 4) on
   synthetic seg-capable 512² batches for 3 optimizer steps: finite loss
   components, frozen parameters bit-identical, trainable ones moved, no
   frozen gradient allocated, launch counts as the layer plan predicts;
   s per step, samples/s, peak device memory, the VAE encodes' share;
6b. the OCR path. (a) PARSeq-base (udifftext_tpu_torch/models/parseq.py)
   with seeded random weights, fp32: the full read (26 greedy steps and the
   cloze refinement) of 16 crops on the card against the same module on the
   CPU (logits' relative L2, the share of greedy ids that agree, those with
   a clear top-2 gap all equal), ms per batch; `ParseqPredictor.calc_loss`
   and its gradient with respect to the images (B=2, 512²) card against CPU.
   (b) The OCR-loss fine-tuning step at full width: the train graph with
   `ocr_enabled: true` (PARSeq frozen in fp32, the denoised latent decoded
   by the fp32 VAE under autograd, the bbox crop read by PARSeq, lambda
   0.001), synthetic 512² samples collated by the port's
   `data.loader.collate` (label_ids, parseq_label_ids, r_bbox), 3 optimizer
   steps of 4 micro-batches of OCR_MICRO_BATCH: every loss component
   finite, the OCR term > 0, PARSeq and the VAE bit-identical without a
   gradient, trainable parameters moved, flash and GEGLU launches as phase
   6 counts them; s per step, samples/s, peak device memory, one step under
   torch.profiler, and the same step with the term off (its share of a
   step). (c) OCR_MICRO_BATCH is the largest power of two that fits in
   80 GB (the decoder keeps its fp32 activations for the backward; measured
   by udifftext_tpu_torch/scripts/ocr_train_probe.py);
7. the demo flow of phase 5 with attend-and-excite and map capture
   (aae_enabled, detailed): output, local losses, middle-step maps, and
   flash-backward launches; s/sample;
8. the glue-fusion probe (udifftext_tpu_torch.scripts.glue_fusion_probe) through
   its entry function at batch 16 (CFG-doubled B=32), K=20, every section's
   time printed; then a full-width BasicTransformerBlock with
   fuse_qkv=True, fuse_glue="auto" against the unfused block on the same
   seeded weights with hoisted K/V (ds1 and ds2) and against the fp32 CPU
   block (ds1), its launch counts per forward, map capture, and one backward
   (input and t_attn/t_norm gradients against the unfused block's);
9. the ResBlock probe (udifftext_tpu_torch.scripts.resblock_probe) through its
   entry function at batch 32, 320 channels, every label printed, its
   GroupNorm on route "cluster" (one device launch a call);
10. the flash-variants probe (udifftext_tpu_torch.scripts.flash_variants)
   through its entry function at B=32, H=5, N=4096, every label printed
   with ms and TFLOP/s, the library line included;
11. serving: udifftext_tpu_torch.scripts.serve_bench's entry function at
   full width with the demo's sampler (50 steps, CFG 4.0, 10 candidates in
   the batched search), buckets (1, 8), pipeline depth 2, on 512² uint8
   requests: a warmup group per bucket, 2 saturated groups of 8, 2 single
   requests. It prints samples/s, each single request's latency (two
   values; `serve_bench` alone with more requests gives percentiles), the
   mean batch size, peak device memory and how much of a later group's
   launch overlapped the group ahead of it; it checks uint8 outputs of the
   right shape that are not constant, every row's replay coordinates, one
   group replayed bit for bit from them, 520 flash and 780 GEGLU launches a group (counted on the
   dispatcher thread), a UNet eval at bucket 8 with kernels against
   attn_impl="plain", and, on a depth-2 service, a request cancelled while
   queued and a shutdown with the pipeline full;
12. the eval CLI (udifftext_tpu_torch.test): `test()` with configs/test.yaml's
   run (TEST_RUN: CFG 5.0, 50 steps, batch 1, 10 candidates in the
   sequential search) at full width with seeded random weights on 3
   synthetic 512² batches with name, label and r_bbox, OCR through a PARSeq
   file of seeded random weights read by `load_predictor`: every real/,
   fake/ and grid PNG read back (zlib) at its size, the accuracy line,
   700 flash and 1050 GEGLU launches a sample (20 search evals and 50
   steps); s per sample and peak memory; with quan_test on, the run's FID
   and LPIPS of fake/ against real/ (the `FID:` and `lpips score:` lines
   required, finite) through weight files of seeded random weights in
   pytorch_fid's and lpips' own key layouts that the three
   UDIFFTEXT_*_WEIGHTS variables name (`write_metric_weights`); then one
   sample with attend-and-excite and map capture through make_predictor →
   predict → average_attn_maps → save_segment_map;
13. the train CLI (udifftext_tpu_torch.train.main): configs/train.yaml's
   run (TRAIN_RUN: batch 16, accumulate 4) at full width on synthetic
   batches, two optimizer steps an epoch for 2 epochs, a checkpoint each
   epoch with 1 kept, image logs every 2 updates, EMA on, inside a
   world-size-1 NCCL process group: launches per micro-batch as phase 6
   plus the image logs' sampling, the checkpoint file and the image PNGs,
   frozen parameters bit-identical and trainable ones moved against a
   fresh engine of the same seed, the checkpoint restored into it
   bit-equal to the run's final parameters, AdamW moments and EMA; s per
   step, samples/s, the checkpoint's GiB, the loop's seconds blocked in
   `save` against the background write's, restore seconds, peak device
   memory and host RSS; then a second run on the same directory resumes at
   the saved step and takes one more epoch;
14. the sampling options, on phase 5's engine and batch (512², CFG 4.0),
   run after phase 5b: (a) UNetModel.forward_cached and decode_cached on its
   own skip stack equal to forward at the demo's CFG-doubled B=2 in bf16,
   with the flash/GEGLU launches `unet_plan` predicts for the whole UNet and
   for its middle and output blocks; (b) encoder propagation with every step
   key equal to the exact 50-step Euler loop; (c) Predictor with
   encprop_interval 2 and 3 (10 candidates in the batched search, 50 steps;
   no checkpoint identity, so the gate warns once): finite, not constant,
   the plan's launches for its key and reuse steps, s per sample (median of
   3, interleaved with the exact predictor's) and the PSNR against the exact
   image (random weights: printed, not gated); (d) the gate refusing a
   checkpoint file with no report, udifftext_tpu_torch.scripts.encprop_quality's
   entry function writing its report, and the gate then passing; (e) Heun,
   Euler-ancestral, DPM++(2S) ancestral, DPM++(2M), LMS and Euler with churn
   for 5 steps through the engine's CFG denoiser: finite, the UNet evals each
   implies in launches, and within phase 5b's relative-L2 tolerance of the
   same sampler on the attn_impl="plain" engine with the same draws;
15. LabelEncoder pretraining and the metrics (no kernel on either path; both
   paths must count 0 launches). (a) configs/pretrain.yaml's model
   (PRETRAIN_RUN: LabelEncoderPretrain with max_len 12, emb 2048, 8 heads,
   12 layers, clip 1024, against a frozen ViTSTR-base) at full width with
   seeded random weights, 5 steps at batch 256 of synthetic 224² label
   batches (`data.synthetic.SyntheticLabelBatches`) through
   `pretrain.train` inside phase 13's world-size-1 NCCL group: s per step
   (median after the first), peak memory, loss and clip_acc per step, all
   finite; then 20 steps on one fixed batch of 32, whose loss must fall.
   (c) In that group, the loss of the all-gathered contrastive features and
   every gradient bit-equal to the plain ones. (b) After the group, one step
   at batch 16 on the card against the same step on the CPU from the same
   weights: loss within 1e-4 relative; the gradients within 1e-2 relative
   L2 (a ReLU input at the rounding level passes its gradient on one side
   only: each such unit moves the gradient by ≈ 1e-3; their count is
   printed); each updated parameter within 1e-6 plus what its gradients'
   disagreement lets Adam's first step differ (up to 2·lr where the
   gradient is at the rounding level); fp32 throughout (TF32 matmul is off
   by default; the patch embedding is a matmul, not a cuDNN conv). (d) FIDInceptionV3's pool3
   features and LPIPSAlex's distances of 8 synthetic 512² images (pairs),
   card against CPU through the metrics module's loaders and weight files
   of seeded random weights, within 1e-2 (relative L2; relative for each
   distance: cuDNN convolutions take TF32 by PyTorch's default, as
   pytorch_fid's run does), and each extractor's images/s at 512². The eval
   CLI's quan_test run is phase 12's;
16. the conditioning surface, on the option graph (`option_graph`: the
   shipped graph with scale-shift norm, the ctrl block (3 hint channels) and
   the label embedding (adm_in_channels 1536), and after the shipped three
   embedders a trainable ClassEmbedder (1000 × 1024), a
   ConcatTimestepEmbedderND (outdim 256) of a (B, 2) size and a trainable
   remapping SpatialRescaler of the 512² hint, three halvings, into the ctrl
   block), seeded random weights, full width. (a) The demo flow of phase 5
   (CFG 4.0, 10 candidates in the batched search, 50 steps) with the cls,
   size and hint keys, 3 runs: finite, in [0, 1], not constant, 520 flash
   and 780 GEGLU launches; s per sample beside phase 5's median in this
   call, the ctrl block's GFLOP a row, peak memory; a 5-step sample with
   kernels against attn_impl="plain" within phase 5b's relative-L2
   tolerance. (d) Encoder propagation refusing the ctrl block. (b) Two
   fine-tuning steps at configs/train.yaml's 16 × 4 with the two trainable
   embedders: frozen parameters bit-identical, every trainable one (t_attn,
   t_norm, both embedders; every class row, by AdamW's decoupled weight
   decay) moved, the flash backward 10 times a micro-batch (the trainable
   embedders sit upstream of the first self-attention; phase 6 counts 9);
   s per step, peak memory. (c) The OpenCLIP ViT-H-14 text tower (24 ×
   1024, 77 tokens; penultimate and EOT-pooled) and vision tower (32 ×
   1280, a 256² image resized to 224²; tokens and pooled), fp32, B=2,
   seeded random weights: card against CPU within 1e-3 relative L2, ms per
   call. Phase 16 prints its own seconds;
17. the VAE's adversarial training (no kernel on the path: the fp32 VAE
   runs cuDNN convs, GroupNorm32 and plain attention): `make_vae_train_steps`
   on builders.TEXTDESIGN_SD_2's first stage (fp32) with taming's default
   NLayerDiscriminator (ndf 64, 3 layers) and LPIPSAlex as the perceptual
   net, seeded weights, B=2 at 256², Adam: one ae_step and one disc_step,
   which fail on non-finite losses, a VAE parameter that did not move in
   ae_step, a discriminator parameter or buffer that ae_step changed, a VAE
   tensor that disc_step changed or a discriminator parameter it did not
   move; then two more of each for the s per step of each half; the peak
   memory from a reset counter;
18. the STR hub (no kernel on the path): each of parseq, parseq-tiny,
   vitstr, abinet, trba and crnn at strhub's base configuration, fp32,
   seeded weights (`randomize_parameters`, saved in strhub's layout and read by
   `create_model`), a forward on 64 synthetic 32×128
   crops: card against CPU on the first 4 rows within 1e-2 relative L2
   (cuDNN convs in TF32), the share of greedy ids that agree, ms per
   forward (CUDA events, median of 5); then two PARSeq-base
   permuted-training steps (6 orderings, backward, AdamW) with a finite
   loss and gradients, each step's seconds;
19. the STR data path, tools and trainer (no kernel on the path): 2,048
   synthetic word crops (heights 16-64, widths 40-400, labels of 1-25
   characters) as `encode_png` PNGs written by `write_lmdb`, and three
   256-crop benchmark-named sets; `get` over every record through the
   native reader (opened directly: a failed g++ build fails the phase) and
   the Python one, records/s, bytes equal; `str_train.train` at PARSeq-base
   width from the LMDB, B=64, 40 steps, SWA from step 31: s/step (median
   of steps 2-40), samples/s, the host's share of a step (LMDB get, PNG
   decode, queuing bicubic_resize), peak memory from a reset counter; it
   fails on a non-finite loss, an averaged parameter outside its
   snapshots' range, or a checkpoint that `create_model` does not load
   strictly; then `str_test --ckpt` on the three sets (tables, .log.txt,
   images/s), `str_bench parseq 64`, `str_read` on two PNGs and
   `str_abinet_lm_acc` with seeded ABINet weights. Phases 17-19 print their
   seconds; phase 19 fails past 60 s;
20. data-parallel serving (`scripts/serve.build_service(dp=2)`) on two ranks
   started by this script (`python3 chip_smoke.py --multicard-rank DIR`,
   torchrun's variables): with one card both share cuda:0 over gloo, which
   the script prints as its choice; with two or more, NCCL on two cards. The
   full-width engine with seeded weights, phase 11's sampler (50 steps, CFG
   4.0, 10 candidates in the batched search), one bucket of 8 distinct 512²
   uint8 requests (4 rows a rank), pipeline depth 2, against the dp-1 service
   on the same seed in this process: the global scores within 1e-4 of their
   largest and bit-equal on the two ranks, the same candidate unless the
   lowest are tied within twice the scores' measured disagreement (then this
   process samples the dp-2 candidate from the same draws; the line prints
   every score's distance from the lowest), the
   images within phase 5b's relative L2 of 5e-2, the replay coordinates
   equal, 520 flash and 780 GEGLU launches on each rank and here, and the
   worker's loop ended by rank 0's shutdown; each rank's peak memory from a
   reset counter and its seconds (no speed-up figure on a shared card);
21. the tensor-parallel fine-tuning step on the same two ranks as one tensor
   group (`parallel/sharding.shard_model_`): TEXTDESIGN_SD_2_TRAIN, seeded
   weights, one micro-batch of 8 synthetic 512² samples with the draws of
   one seeded generator, against the unsharded step in this process: loss
   within 1e-2 relative, the trainable gradients (shards gathered) within
   5e-2 relative L2, the updated parameters differing by no more than the
   gradients' disagreement lets Adam's first step differ, every trainable
   tensor moved, the replicated gradients and updates bit-equal on the two
   ranks, a shard then gather of the state dict bit-equal,
   `tp_report` listing the ten ds1 attention modules, and 10 flash forward,
   9 flash backward and 15 GEGLU launches on each rank. A failure in a rank
   fails the phase; the ranks are killed on the way out;
22. the stage and floor probes (udifftext_tpu_torch/scripts: profile_components,
   profile_transformer, kv_hoist_probe, step_floor_probe, train_probe,
   pipeline_probe, perf_probe, test_parity_probe, geglu_sweep) through their
   entry functions at full width (the shipped graph with seeded weights, the
   JAX scripts' shapes and step counts) at 1 sample (2 UNet rows) and one
   timed call after a warm-up, each printing its table under the card's
   name and power limit: every label present with a finite positive time;
   inline and hoisted K/V bit-equal; every swept GEGLU plan within the
   bf16 tolerance of the plain version; the whole `engine.sample`
   bit-equal to its stages composed; the
   pipeline's operation count equal to 50 evals' plus the K/V hoist's and
   the decode's; launches as the UNet's plan and the shape gates predict
   (one UNet eval 10 flash and 15 GEGLU; a backward with every gradient 10
   flash backward, with the trainable ones 9; the sweep's direct launches
   of the GEGLU entry, a check and the timed calls a plan, on their own
   path `probes_sweep_entry`); within 120 s, the phase's seconds on a
   `[phases]` line.

Beside every kernel's time stand its plain version's, its bound (the least
time the card could take: the larger of bytes moved once over 3.35 TB/s and
operations over 989 TFLOP/s for bf16, 67 TFLOP/s for fp32) and, where one
PyTorch call computes the same function (scaled_dot_product_attention;
group_norm then silu), that call's time on the same inputs; the port itself
never calls it.

Each path (demo, AAE, training, OCR-loss training, glue probe, ResBlock
probe, variants probe, serving, eval CLI, train CLI, encoder propagation at
interval 2, the other samplers, pretraining, the metrics, the options demo,
the options fine-tuning, the VAE GAN steps, the STR hub, the STR trainer
and the STR tools, dp serving, the tensor-parallel step, the probes of phase
22 and the GEGLU sweep's direct launches) runs with the
launch counts set to 0 just before it and read just after (phases 20 and 21
count in each rank; their `dp_serve` and `tp_train` entries are rank 0's).
Any failure exits non-zero. The
second-to-last line is the kernels' JSON record: each kernel's `launches`
counts the path named by its `launches_path` (training for the kernels the
UNet runs, the glue probe for the four that only the fused block runs, the
ResBlock probe for the fused GroupNorm, the variants probe for v1-v4),
`launches_by_path` holds every path's count, and the flash, GEGLU,
t_attn, GroupNorm and variant kernels carry `kernel_route`, the route of
their recorded case (ln_gemm and ln_gemm3 too). The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import resource
import socket
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


def back_to_back_ms(fn, n: int = 20) -> float:
    """Milliseconds a call of `fn` takes when `n` are queued back to back
    (one pair of CUDA events around them): the device's time for a kernel
    whose single calls are dominated by the host's launch cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bf16_tol(ref) -> float:
    """Two bf16 ulps of the largest reference value: one rounding of the
    kernel's output, with the plain version's own output rounding."""
    return 2**-7 * max(1.0, float(ref.float().abs().max()))


def grad_tol(ref) -> float:
    """Two bf16 ulps of the gradient's largest entry (bf16; one rounding of
    each gradient, both sides computing in fp32), 1e-5 of it in fp32."""
    import torch

    return (2**-7 if ref.dtype == torch.bfloat16 else 1e-5) * float(ref.float().abs().max())


# csrc/geglu.cu geglu_mma_kernel<NT, G, RG>: output tiles a warpgroup, warpgroups
# over the same rows, row groups a block (C = 64·NT·G)
GEGLU_MMA_SHAPES = ([(nt, 1, rg) for rg in (1, 2) for nt in (1, 2, 3, 4, 5)]
                    + [(nt, g_, 1) for g_ in (2, 4) for nt in (3, 4, 5)])
def record(records: dict, key: str, label: str, err: float, ms: float, plain_ms: float,
           bound: tuple, library_ms=None) -> str:
    """Keep the first case of each kernel for the JSON line; returns the
    bound and library part of the case's log line."""
    records.setdefault(key, {"shape": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound[0], "bound_by": bound[1],
                             "library_ms": library_ms})
    lib = "" if library_ms is None else f", library call {library_ms:.3f} ms"
    return f"bound {bound[0]:.4f} ms by {bound[1]}{lib}"


def rel_l2(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).norm() / want.norm())


def counts(*fns) -> dict:
    """Launch counts by wrapper name; a wrapper that counts per variant in a
    dict gives one entry per variant, `<name>_<variant>`."""
    out = {}
    for f in fns:
        if isinstance(f.launches, dict):
            out.update({f"{f.__name__}_{k}": n for k, n in f.launches.items()})
        else:
            out[f.__name__] = f.launches
    return out


def reset(*fns) -> None:
    for f in fns:
        if isinstance(f.launches, dict):
            f.launches.update(dict.fromkeys(f.launches, 0))
        else:
            f.launches = 0


# kernel-name fragments (lower case) → the groups of the device-time breakdown,
# first match wins
KERNEL_GROUPS = (
    ("flash forward", ("flash_fwd",)),
    ("flash backward", ("flash_bwd",)),
    ("GEGLU kernels", ("geglu",)),
    ("cuDNN convs", ("cudnn", "fprop", "dgrad", "wgrad", "conv", "winograd")),
    ("cuBLAS", ("gemm", "gemv", "cublas", "cutlass")),
    ("norm, softmax and other reductions", ("reduce", "norm", "softmax", "welford")),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "fill", "cat", "index",
                                "memcpy", "memset")),
)


def profile_groups(label: str, fn, path_s: float) -> None:
    """One call of `fn` in a `utils.profiling.trace` window (device activity
    only): logs the device time, its share of `path_s` (the seconds the same
    call took without the profiler, which slows the host several times
    over) and the device milliseconds and launches of each kernel group."""
    import torch

    from udifftext_tpu_torch.utils.profiling import trace

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(None, host=False) as prof:  # the trace stays in memory
        fn()
    wall = time.perf_counter() - t0
    groups = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:  # older torch
            us = ev.self_cuda_time_total
        if us <= 0:  # the runtime's own calls
            continue
        name = ev.key.lower()
        group = next((g for g, frags in KERNEL_GROUPS if any(f in name for f in frags)), "other")
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + us / 1e3, n + ev.count)
    device_ms = sum(ms for ms, _ in groups.values())
    if device_ms <= 0:
        log(f"[profile] {label}: the profiler recorded no device time: not measured")
        return
    parts = ", ".join(f"{g} {ms:.1f} ms ({n})" for g, (ms, n) in
                      sorted(groups.items(), key=lambda kv: -kv[1][0]))
    log(f"[profile] {label}: device time {device_ms:.1f} ms, {device_ms / 1e3 / path_s:.3f} of "
        f"the {path_s:.3f} s the call takes ({wall:.3f} s under the profiler); by kernel group, "
        f"ms (launches): {parts}")


# the reference checkpoint's prefix of each engine component
CKPT_PREFIXES = (("unet", "model.diffusion_model."), ("vae", "first_stage_model."),
                 ("label_encoder", "conditioner.embedders.0."))
# the UNet parameters the reference zero-initializes (zero_module): t_attn's
# output projection and proj_out of the 16 transformers, the last conv of the
# 22 ResBlocks, and the UNet's last conv, weights and biases: 110 at full width
ZERO_INIT = re.compile(r"(\.t_attn\.to_out\.0|\.proj_out|\.out_layers\.3|^out\.2)\.(weight|bias)$")
ZERO_INIT_KEYS = 110
# phase 6b's micro-batch: the largest power of two whose OCR-loss step fits in
# 80 GB (scripts/ocr_train_probe.py; PERF.md records the peak at each size)
OCR_MICRO_BATCH = 8
SAFETENSORS_DTYPES = {"torch.float32": "F32", "torch.bfloat16": "BF16", "torch.float16": "F16"}


def write_safetensors(path: str, tensors: dict) -> None:
    """A .safetensors file written directly: 8-byte little-endian header
    length, the JSON header, then each tensor's bytes in order."""
    import torch

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for data in blobs:
            f.write(data)


# configs/test.yaml and configs/train.yaml as dicts (the card's machine has no
# PyYAML); tests/test_torch_eval_cli.py and tests/test_torch_train_cli.py hold
# each equal to its file, and phases 12 and 13 change only the keys listed in
# EVAL_OVERRIDES / TRAIN_OVERRIDES
TEST_RUN = {
    "type": "test", "load_ckpt_path": "./checkpoints/{your checkpoint path}.ckpt",
    "model_cfg_path": "./configs/test/textdesign_sd_2.yaml",
    "dataset_cfg_path": "./configs/dataset/icd13.yaml", "output_dir": "./outputs",
    "temp_dir": "./temp", "channel": 4, "factor": 8, "scale": [5.0, 0.0], "noise_iters": 10,
    "force_uc_zero_embeddings": ["label"], "aae_enabled": False, "detailed": False,
    "encprop_interval": 0, "bf16": True, "steps": 50, "init_step": 0,
    "eval_data_parallel": False, "batch_size": 1, "num_workers": 0, "max_iter": 100,
    "shuffle": True, "quan_test": False, "ocr_enabled": True,
    "predictor_config": {"target": "sgm.modules.predictors.model.ParseqPredictor",
                         "params": {"ckpt_path": "./checkpoints/predictors/parseq-bb5792a6.pt"}},
}
TRAIN_RUN = {
    "type": "train", "save_ckpt_dir": "./checkpoints",
    "load_ckpt_path": "./checkpoints/pretrained/512-inpainting-ema.ckpt",
    "model_cfg_path": "./configs/train/textdesign_sd_2.yaml",
    "dataset_cfg_path": "./configs/dataset/locr.yaml", "save_ckpt_freq": 1, "num_workers": 0,
    "batch_size": 16, "base_learning_rate": 5e-05, "shuffle": False, "bf16": True,
    "lightning": {"max_epochs": 100, "accumulate_grad_batches": 4,
                  "default_root_dir": "./logs/base_logs"},
}
PRETRAIN_RUN = {
    "ckpt_dir": "./checkpoints/encoders/LabelEncoder",
    "dataset": {"target": "dataset.dataloader.LabelDataset",
                "params": {"size": 224, "length": 100000, "font_path": None, "min_len": 1,
                           "max_len": 12}},
    "model": {"target": "sgm.modules.encoders.modules.LabelEncoder",
              "params": {"trainable": True, "max_len": 12, "emb_dim": 2048, "n_heads": 8,
                         "n_trans_layers": 12, "lr": "1e-5", "lambda_cls": 0.1,
                         "lambda_pos": 0.1,
                         "visual_config": {
                             "target": "sgm.modules.encoders.modules.ViTSTREncoder",
                             "params": {"freeze": True, "ckpt_path":
                                        "./checkpoints/encoders/ViTSTR/vitstr_base_patch16_224.pth",
                                        "size": 224, "patch_size": 16, "embed_dim": 768,
                                        "depth": 12, "num_heads": 12, "mlp_ratio": 4,
                                        "qkv_bias": True, "in_chans": 1}}}},
    "num_workers": 0, "batch_size": 256, "check_freq": 5,
    "lightning": {"max_epochs": 1000, "default_root_dir": "./logs/pre_logs"},
}
METRIC_ENV = ("UDIFFTEXT_FID_WEIGHTS", "UDIFFTEXT_LPIPS_WEIGHTS", "UDIFFTEXT_ALEXNET_WEIGHTS")
EVAL_OVERRIDES = ("load_ckpt_path", "output_dir", "temp_dir", "max_iter", "quan_test",
                  "predictor_config.params.ckpt_path")
TRAIN_OVERRIDES = ("load_ckpt_path", "save_ckpt_dir", "keep_ckpts", "log_dir", "log_images_freq",
                   "use_ema", "lightning.max_epochs")


def eval_run_config(work_dir: str, parseq_path: str) -> dict:
    """Phase 12's run config: configs/test.yaml with no UDiffText checkpoint
    (seeded random weights), outputs under `work_dir`, 3 batches, a PARSeq
    file of seeded random weights, and FID/LPIPS (quan_test) on."""
    cfgs = copy.deepcopy(TEST_RUN)
    cfgs.update(load_ckpt_path=f"{work_dir}/none.ckpt", output_dir=f"{work_dir}/outputs",
                temp_dir=f"{work_dir}/temp", max_iter=3, quan_test=True)
    cfgs["predictor_config"]["params"]["ckpt_path"] = parseq_path
    return cfgs


def train_run_config(work_dir: str, max_epochs: int = 2) -> dict:
    """Phase 13's run config: configs/train.yaml with no bootstrap checkpoint
    (seeded random weights), checkpoints and logs under `work_dir`, one
    checkpoint kept, image logs every 2 updates, EMA on, `max_epochs`."""
    cfgs = copy.deepcopy(TRAIN_RUN)
    cfgs.update(load_ckpt_path=f"{work_dir}/none.ckpt", save_ckpt_dir=f"{work_dir}/ckpt",
                keep_ckpts=1, log_dir=f"{work_dir}/logs", log_images_freq=2, use_ema=True)
    cfgs["lightning"]["max_epochs"] = max_epochs
    return cfgs


def write_metric_weights(work_dir: str, seed: int = 0) -> dict:
    """FIDInceptionV3 and LPIPSAlex of seeded random weights saved in the
    published files' key layouts: pytorch_fid's Inception (with `AuxLogits`
    and `fc` entries, which the loader drops), and lpips' lin-only file
    beside a torchvision AlexNet file (`features.*`, a `classifier` layer),
    so that all three variables are read. Convolutions are He-scaled (at
    lecun scale the pool3 features barely depend on the input) and the lin
    weights non-negative, as lpips' are. Returns the variables naming them."""
    import torch

    from udifftext_tpu_torch.models.inception import FIDInceptionV3
    from udifftext_tpu_torch.models.lpips import LPIPSAlex

    gen = torch.Generator().manual_seed(seed)
    inception, lpips = FIDInceptionV3(), LPIPSAlex()
    with torch.no_grad():
        for m in list(inception.modules()) + list(lpips.modules()):
            if isinstance(m, torch.nn.Conv2d):
                w = torch.randn(m.weight.shape, generator=gen) * (2 / m.weight[0].numel()) ** 0.5
                m.weight.copy_(w.abs() if m.out_channels == 1 else w)
    fid_sd = dict(inception.state_dict(), **{
        "AuxLogits.fc.weight": torch.zeros(1000, 768), "AuxLogits.fc.bias": torch.zeros(1000),
        "fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)})
    lp_sd = lpips.state_dict()
    alexnet = {f"features.{k.split('.')[2]}.{k.split('.')[3]}": v for k, v in lp_sd.items()
               if k.startswith("net.")}
    alexnet.update({"classifier.6.weight": torch.zeros(1000, 4096),
                    "classifier.6.bias": torch.zeros(1000)})
    files = {}
    for name, sd, file in zip(METRIC_ENV, (fid_sd, {k: v for k, v in lp_sd.items()
                                                    if k.startswith("lin")}, alexnet),
                              ("pt_inception-2015-12-05.pth", "lpips_alex.pth", "alexnet.pth")):
        files[name] = f"{work_dir}/{file}"
        torch.save(sd, files[name])
    return files


class Tee:
    """A stdout that also keeps what was written to it."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def peak_rss_gib() -> float:
    """This process's peak resident set so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def plan_launches(unet, hw: int) -> tuple:
    """((flash, GEGLU) launches of the UNet's encoder, (flash, GEGLU) of its
    middle and output blocks) for one bf16 eval at latent size hw² on the
    card, from `unet.plan` and the wrappers' shape gates: a self-attention
    takes the flash kernel where `flash_shape_ok` holds, a feed-forward the
    GEGLU kernel where `geglu_shape_ok` holds."""
    from udifftext_tpu_torch.models.attention import geglu_shape_ok
    from udifftext_tpu_torch.ops.attention import flash_shape_ok

    def count(blocks):
        fl = ge = 0
        for specs in blocks:
            for s in specs:
                if s.kind == "attn":
                    n = (hw // s.ds) ** 2
                    fl += unet.transformer_depth * flash_shape_ok(n, n, s.dim_head)
                    ge += unet.transformer_depth * geglu_shape_ok(n)
        return fl, ge

    return count(unet.plan.input_blocks), count((unet.plan.middle_block,)
                                                + unet.plan.output_blocks)


def sampling_options(engine, plain_engine, batch, kernel_fns, expected, by_path, tol) -> None:
    """Phase 14: the sampling options on phase 5's full-width engine and
    batch (512², B=1, CFG 4.0), beside `plain_engine` (the same seeded
    weights under attn_impl="plain")."""
    import numpy as np
    import torch

    from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2
    from udifftext_tpu_torch.diffusion import sampling as SP
    from udifftext_tpu_torch.predict import Predictor
    from udifftext_tpu_torch.scripts import encprop_quality
    from udifftext_tpu_torch.utils import encprop_gate

    dev = engine.device
    fns = kernel_fns
    size = batch["image"].shape[1]
    hw = size // engine.latent_factor
    (enc_fl, enc_ge), (dec_fl, dec_ge) = plan_launches(engine.unet, hw)

    def evals(full: int, decode: int = 0) -> dict:
        """Launch counts of `full` whole UNet evals and `decode` decode_cached ones."""
        return expected(flash_attention=full * (enc_fl + dec_fl) + decode * dec_fl,
                        geglu_ff=full * (enc_ge + dec_ge) + decode * dec_ge)

    # (a) the cached entry points at the demo's CFG-doubled B=2, bf16, kernels
    g = torch.Generator(dev).manual_seed(14)
    unet = engine.unet
    x = torch.randn(2, hw, hw, unet.in_channels, generator=g, device=dev).to(unet.dtype)
    t = torch.tensor([0.3, 0.3], device=dev)
    ctx = torch.randn(2, 12, unet.t_context_dim, generator=g, device=dev).to(unet.dtype)
    got = {}
    with torch.no_grad():
        for name, call in (("forward", lambda: unet(x, t, ctx, None)[0]),
                           ("forward_cached", lambda: unet.forward_cached(x, t, ctx)),
                           ("decode_cached", lambda: unet.decode_cached(hs, t, ctx))):
            reset(*fns)
            got[name] = call()
            torch.cuda.synchronize()
            got[name + " launches"] = counts(*fns)
            if name == "forward_cached":
                got[name], hs = got[name]
    log(f"[sampling] (a) forward_cached and decode_cached on its own stack against forward "
        f"(B=2, bf16): max |Δ| {float((got['forward_cached'] - got['forward']).abs().max()):.3e} "
        f"/ {float((got['decode_cached'] - got['forward']).abs().max()):.3e}; skip stack of "
        f"{len(hs)}; launches {got['forward_cached launches']} / {got['decode_cached launches']} "
        f"(the plan: encoder {enc_fl} flash / {enc_ge} GEGLU, middle and output blocks "
        f"{dec_fl} / {dec_ge})")
    if not (torch.equal(got["forward_cached"], got["forward"])
            and torch.equal(got["decode_cached"], got["forward"])):
        fail("forward_cached or decode_cached on its own stack differs from forward")
    if (got["forward launches"] != evals(1) or got["forward_cached launches"] != evals(1)
            or got["decode_cached launches"] != evals(0, 1)):
        fail(f"cached entry points launched {got}, the plan predicts {evals(1)} / {evals(0, 1)}")
    del x, ctx, hs, got

    # (b) all-key encoder propagation against the exact sampler on one latent
    arr = Predictor(engine).array_batch(batch)
    shape = (1, hw, hw, 4)
    eps = torch.randn(shape, generator=g, device=dev)
    with torch.no_grad():
        c, uc = engine.conditionings(arr, eps)
        sigmas = torch.as_tensor(engine.discretization(50), device=dev)
        x50 = SP.init_latent(torch.randn(shape, generator=g, device=dev), sigmas)
        exact = SP.sample_euler_edm(engine.make_denoise_fn(c, uc, 4.0), x50, sigmas)
        allkey = SP.sample_euler_edm_encprop(*engine.make_denoise_fns_encprop(c, uc, 4.0), x50,
                                             sigmas, SP.uniform_key_mask(50, 1))
    log(f"[sampling] (b) all-key encoder propagation against sample_euler_edm, 50 steps: max "
        f"|Δ| {float((allkey - exact).abs().max()):.3e}")
    if not torch.equal(allkey, exact):
        fail("all-key encoder propagation differs from the exact Euler loop")

    # (c) Predictor(encprop_interval=k) against the exact predictor, interleaved
    preds = {k: Predictor(engine, num_steps=50, cfg_scale=4.0, noise_iters=10,
                          noise_search_batched=True, encprop_interval=k) for k in (0, 2, 3)}
    secs = {k: [] for k in preds}
    images = {}
    for _ in range(3):
        for k, pred in preds.items():
            reset(*fns)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images[k], _ = pred(batch, torch.Generator(dev).manual_seed(0))
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t0)
            launches = counts(*fns)
            n_key = int(SP.uniform_key_mask(50, k).sum()) if k else 50
            want = evals(2 + n_key, 50 - n_key)  # 2 batched search evals, then the steps
            if launches != want:
                fail(f"encprop interval {k}: launches {launches}, the plan predicts {want} "
                     f"({n_key} key steps)")
            if k == 2:
                by_path["encprop"] = launches
    for k in (2, 3):
        img = images[k].float()
        mse = float(((img - images[0].float()) ** 2).mean())
        if not (torch.isfinite(img).all() and float(img.std()) > 0):
            fail(f"encprop interval {k}: the image is not finite or is constant")
        log(f"[sampling] (c) Predictor(encprop_interval={k}) ({size}², 10 candidates, 50 steps, CFG "
            f"4.0): {statistics.median(secs[k]):.3f} s per sample (median of 3: "
            f"{[round(v, 3) for v in secs[k]]}) against the exact sampler's "
            f"{statistics.median(secs[0]):.3f} s ({[round(v, 3) for v in secs[0]]}); "
            f"{int(SP.uniform_key_mask(50, k).sum())} key steps; PSNR against the exact image "
            f"{10 * np.log10(1.0 / max(mse, 1e-12)):.2f} dB (random weights: printed, not "
            f"gated); launches {by_path['encprop'] if k == 2 else launches}")
    profile_groups("encprop interval 2, one sample",
                   lambda: preds[2](batch, torch.Generator(dev).manual_seed(0)),
                   statistics.median(secs[2]))
    del preds, images

    # (d) the quality script's report and the gate, for a checkpoint file
    saved_env = os.environ.get("UDIFFTEXT_ENCPROP_REPORTS")
    with tempfile.TemporaryDirectory(prefix="udt_encprop_") as rep_dir:
        os.environ["UDIFFTEXT_ENCPROP_REPORTS"] = rep_dir
        fake = os.path.join(rep_dir, "fake.ckpt")
        with open(fake, "wb") as f:
            f.write(np.random.RandomState(14).bytes(1 << 20))
        cid = encprop_gate.ckpt_file_id(fake)
        kw = dict(num_steps=50, cfg_scale=4.0, noise_iters=10, ckpt_id=cid)
        try:
            Predictor(engine, encprop_interval=2, **kw)
            fail("the gate admitted encprop for a checkpoint with no report")
        except RuntimeError as e:
            if "no quality report" not in str(e):
                raise
        t0 = time.perf_counter()
        res = encprop_quality.run(TEXTDESIGN_SD_2, steps=50, intervals=(2, 3), size=size,
                                  scale=4.0, report_id=cid, device=str(dev))
        quality_s = time.perf_counter() - t0
        default = encprop_gate.DEFAULT_MIN_PSNR
        verdicts = {}
        for k in (2, 3):
            # the report passes the gate at its own PSNR; the default gate
            # passes it or refuses it as that PSNR says
            psnr = res["intervals"][str(k)]["psnr"]
            Predictor(engine, encprop_interval=k, min_quality_psnr=min(default, psnr), **kw)
            try:
                Predictor(engine, encprop_interval=k, **kw)
                verdicts[k] = "passed"
            except RuntimeError as e:
                verdicts[k] = "refused" if "below the" in str(e) else str(e)
            if verdicts[k] != ("passed" if psnr >= default else "refused"):
                fail(f"interval {k} at {psnr} dB: the default gate {verdicts[k]}")
        log(f"[sampling] (d) encprop_quality.run for checkpoint {cid} in {quality_s:.1f} s: "
            f"{res['intervals']}; without the report the gate refused, with it the gate passed "
            f"at each interval's PSNR and at the default {default} dB {verdicts}")
        if not (res["report_path"] and os.path.exists(res["report_path"])):
            fail(f"the quality script wrote no report: {res}")
    if saved_env is None:
        os.environ.pop("UDIFFTEXT_ENCPROP_REPORTS")
    else:
        os.environ["UDIFFTEXT_ENCPROP_REPORTS"] = saved_env
    del res
    torch.cuda.empty_cache()

    # (e) the other samplers, 5 steps, kernels against attn_impl="plain" on the
    # same weights and draws
    sig5 = torch.as_tensor(engine.discretization(5), device=dev)
    x5 = SP.init_latent(torch.randn(shape, generator=g, device=dev), sig5)
    draws = [torch.randn(shape, generator=g, device=dev) for _ in range(5)]
    churn = SP.EDMStochasticParams(s_churn=1.0)
    samplers = (  # (name, sampler, UNet evals)
        ("heun_edm", lambda d: SP.sample_heun_edm(d, x5, sig5), 9),
        ("euler_ancestral", lambda d: SP.sample_euler_ancestral(d, x5, sig5, noise=draws), 5),
        ("dpmpp2s_ancestral", lambda d: SP.sample_dpmpp2s_ancestral(d, x5, sig5, noise=draws), 9),
        ("dpmpp2m", lambda d: SP.sample_dpmpp2m(d, x5, sig5), 5),
        ("lms", lambda d: SP.sample_lms(d, x5, sig5), 5),
        ("euler_edm_churn", lambda d: SP.sample_euler_edm(d, x5, sig5, churn, noise=draws), 5),
    )
    with torch.no_grad():
        den = engine.make_denoise_fn(c, uc, 4.0)
        pc, puc = plain_engine.conditionings(arr, eps)
        plain_den = plain_engine.make_denoise_fn(pc, puc, 4.0)
        total = dict.fromkeys(evals(0), 0)
        for name, sampler, n_evals in samplers:
            reset(*fns)
            z = sampler(den)
            torch.cuda.synchronize()
            launches = counts(*fns)
            z_plain = sampler(plain_den)
            err = rel_l2(z, z_plain)
            log(f"[sampling] (e) {name}, 5 steps: {n_evals} UNet evals, launches {launches}; "
                f"relative L2 against attn_impl='plain' {err:.3e} (tol {tol:.0e})")
            if launches != evals(n_evals):
                fail(f"{name} launched {launches}, {n_evals} UNet evals predict {evals(n_evals)}")
            if not (torch.isfinite(z).all() and err <= tol):
                fail(f"{name} is not finite or disagrees with its attn_impl='plain' run")
            total = {k_: total[k_] + n for k_, n in launches.items()}
    by_path["samplers"] = total


# The option graph: the shipped test graph with every model-graph option
# the shipped one leaves off (scale-shift norm, the ctrl block, the label
# embedding) and three more embedders after the shipped three: vector
# 1024 + 2·256 = 1536 = adm_in_channels; concat 1 + 4 + 3, so the UNet reads
# 9 + 3 channels, the remapped hint going to the ctrl block
_M = "sgm.modules.encoders.modules."
OPTION_EMBEDDERS = (
    {"is_trainable": True, "ucg_rate": 0.1, "input_key": "cls", "target": _M + "ClassEmbedder",
     "params": {"embed_dim": 1024, "n_classes": 1000}},
    {"input_key": "size", "target": _M + "ConcatTimestepEmbedderND", "params": {"outdim": 256}},
    {"is_trainable": True, "input_key": "hint", "target": _M + "SpatialRescaler",
     "params": {"in_channels": 3, "multiplier": 0.5, "n_stages": 3, "out_channels": 3}},
)


def option_graph(base: dict) -> dict:
    graph = copy.deepcopy(base)
    graph["network_config"]["params"].update(use_scale_shift_norm=True, ctrl_channels=3,
                                             use_label=1, adm_in_channels=1536)
    graph["conditioner_config"]["params"]["emb_models"] += copy.deepcopy(list(OPTION_EMBEDDERS))
    return graph


def option_keys(batch: dict, seed: int) -> dict:
    """`batch` with the option graph's extra keys: a class id, the (h, w)
    size and a [-1, 1] hint image of the batch's size."""
    import numpy as np

    rs = np.random.RandomState(seed)
    b, h, w = batch["image"].shape[:3]
    return {**batch, "cls": rs.randint(0, 999, (b,)).astype(np.int64),
            "size": np.tile(np.array([[h, w]], np.float32), (b, 1)),
            "hint": np.clip(np.asarray(batch["image"])[..., ::-1] * 0.5
                            + 0.1 * rs.standard_normal((b, h, w, 3)), -1, 1).astype(np.float32)}


def conditioning_options(dev, card: str, kernel_fns, expected, by_path, demo_s: float,
                         ab_tol: float) -> None:
    """Phase 16: the conditioning surface at full width (the option
    graph, seeded random weights): (a) the demo flow, (b) two fine-tuning
    steps with the two trainable embedders, (c) the OpenCLIP ViT-H-14
    towers card against CPU, (d) encoder propagation refusing the ctrl
    block."""
    import numpy as np
    import torch

    from udifftext_tpu_torch import demo
    from udifftext_tpu_torch.builders import (TEXTDESIGN_SD_2, TEXTDESIGN_SD_2_TRAIN,
                                              build_engine, randomize_parameters)
    from udifftext_tpu_torch.data.synthetic import SyntheticBatches
    from udifftext_tpu_torch.models.open_clip import (FrozenOpenCLIPImageEmbedder,
                                                      FrozenOpenCLIPTextEmbedder,
                                                      OpenClipTextTransformer,
                                                      OpenClipVisionTransformer)
    from udifftext_tpu_torch.models.unet import CTRL_WIDTHS
    from udifftext_tpu_torch.predict import Predictor
    from udifftext_tpu_torch.train import train

    t_phase = time.perf_counter()
    graph = option_graph(TEXTDESIGN_SD_2)
    bundle = build_engine(graph, torch.bfloat16, dev)
    engine = bundle.engine
    randomize_parameters(engine, 0)
    gc = engine.general_conditioner
    if gc is None or gc.trainable_embedders != ("3_ClassEmbedder", "5_SpatialRescaler"):
        fail("the option graph built no GeneralConditioner with the two trainable embedders")
    rs = np.random.RandomState(16)
    yy, xx = np.mgrid[0:600, 0:800]
    image = np.stack([(xx * 255 // 800), (yy * 255 // 600), ((xx + yy) % 256)], -1)
    image = (image + rs.randint(0, 32, image.shape)).clip(0, 255).astype(np.uint8)
    mask = np.zeros((600, 800), np.uint8)
    mask[220:380, 200:600] = 255
    batch = option_keys(demo.build_batch(image, mask, "HELLO", 512, 512, 12), 16)
    ctrl_gflop = 2 * 9 * 64 * 64 * sum(a * b for a, b in zip((3,) + CTRL_WIDTHS,
                                                             CTRL_WIDTHS + (320,))) / 1e9

    # (a) the demo flow: CFG 4.0, 10 candidates in the batched search, 50 steps
    pred = Predictor(engine, num_steps=50, cfg_scale=4.0, noise_iters=10,
                     noise_search_batched=True)
    secs, want = [], expected(flash_attention=52 * 10, geglu_ff=52 * 15)
    held = torch.cuda.memory_allocated(dev) / 2**30  # the engine and what earlier phases hold
    torch.cuda.reset_peak_memory_stats(dev)
    for run in range(3):  # the first builds caches
        reset(*kernel_fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, aux = pred(batch, torch.Generator(dev).manual_seed(run))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = counts(*kernel_fns)
        if launches != want:
            fail(f"options demo launches {launches}, the plan {want}")
        if tuple(images.shape) != (1, 512, 512, 3) or not (
                torch.isfinite(images).all() and float(images.min()) >= 0.0
                and float(images.max()) <= 1.0 and float(images.std()) > 0):
            fail("options demo output is not a finite, non-constant (1, 512, 512, 3) in [0, 1]")
    by_path["options"] = launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[options] {card}: demo with scale-shift norm, ctrl block ({ctrl_gflop:.2f} GFLOP a row), "
        f"label embedding of a 1536-wide vector and six embedders: "
        f"{[round(x_, 3) for x_ in secs]} s per sample (B=1, 512², 10 candidates, 50 steps, CFG "
        f"4.0), median after the first {statistics.median(secs[1:]):.3f} s against phase 5's "
        f"{demo_s:.3f} s in this call; peak device memory {peak:.2f} GiB ({held:.2f} GiB "
        f"allocated before, the engine's weights included); launches {launches}; "
        f"output mean {float(images.mean()):.4f} std {float(images.std()):.4f}")
    plain = build_engine(graph, torch.bfloat16, dev, attn_impl="plain").engine
    randomize_parameters(plain, 0)
    short = {}
    for name, eng in (("auto", engine), ("plain", plain)):
        reset(*kernel_fns)
        short[name], _ = Predictor(eng, num_steps=5, cfg_scale=4.0, noise_iters=10,
                                   noise_search_batched=True)(batch,
                                                              torch.Generator(dev).manual_seed(0))
        got = counts(*kernel_fns)
        if got != (expected(flash_attention=70, geglu_ff=105) if name == "auto" else expected()):
            fail(f"a 5-step options sample under {name!r} launched {got}")
    err = rel_l2(short["auto"], short["plain"])
    log(f"[options] 5-step sample with kernels against attn_impl='plain': relative L2 {err:.3e} "
        f"(tol {ab_tol:.0e})")
    if not err <= ab_tol:
        fail("the options graph with kernels disagrees with attn_impl='plain'")

    # (d) encoder propagation refuses the ctrl block before any work
    try:
        Predictor(engine, num_steps=50, noise_iters=10, encprop_interval=2)(batch)
        fail("encoder propagation ran on a UNet with the ctrl block")
    except NotImplementedError as e:
        log(f"[options] encprop on the ctrl graph refused: {e}")
    del plain, eng, pred, short, images, aux, engine, bundle, gc
    torch.cuda.empty_cache()

    # (b) two fine-tuning steps at configs/train.yaml's 16 × 4 with the two
    # trainable embedders (the train graph with the options)
    accum, micro_b, steps = 4, 16, 2
    bundle = build_engine(option_graph(TEXTDESIGN_SD_2_TRAIN), torch.bfloat16, dev, train=True)
    engine = bundle.engine
    randomize_parameters(engine, 0)
    # host copies, as phase 6 takes them, so that the peak compares with its peak
    frozen = {n: p.detach().cpu().clone() for n, p in engine.named_parameters()
              if not p.requires_grad}
    trained = {n: p.detach().cpu().clone() for n, p in engine.named_parameters()
               if p.requires_grad}
    emb_names = [n for n in trained if n.startswith("general_conditioner.")]
    batches = [option_keys(b_, i_) for i_, b_ in
               enumerate(SyntheticBatches(accum, micro_b, seed=0).batches)]
    with tempfile.TemporaryDirectory(prefix="udt_options_") as log_dir:
        cfgs = {"batch_size": micro_b, "base_learning_rate": 5e-5, "log_dir": log_dir,
                "lightning": {"accumulate_grad_batches": accum, "max_epochs": steps}}
        reset(*kernel_fns)
        held = torch.cuda.memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train(cfgs, batches, bundle, seed=0, log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = by_path["options_train"] = counts(*kernel_fns)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        with open(f"{log_dir}/train_metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
    after = {n: p.detach().cpu() for n, p in engine.named_parameters()}
    unchanged = [n for n, v in frozen.items() if not torch.equal(v, after[n])]
    moved = {n for n, v in trained.items() if not torch.equal(v, after[n])}
    table = "general_conditioner.embedders.3.embedding.weight"
    rows_moved = int((trained[table] != after[table]).any(dim=1).sum())
    n_mb = steps * accum
    want = expected(flash_attention=n_mb * 10, flash_attention_bwd=n_mb * 10,
                    geglu_ff=n_mb * 15)
    log(f"[options] {steps} fine-tuning steps of {accum}×{micro_b} in {train_s:.3f} s (the "
        f"second {rows[-1]['time'] - rows[0]['time']:.3f} s); trainable {len(trained)} tensors "
        f"({len(emb_names)} of the embedders: {emb_names}), {len(moved)} moved, "
        f"{rows_moved} of 1000 class rows moved (AdamW's decoupled weight decay); {len(frozen)} "
        f"frozen, {len(unchanged)} changed; loss {[round(r_['loss'], 4) for r_ in rows]}; "
        f"peak device memory {peak:.2f} GiB ({held:.2f} GiB allocated before); launches "
        f"{launches} (the flash backward 10 a "
        f"micro-batch: the trainable embedders sit upstream of the first self-attention)")
    if unchanged or moved != set(trained) or len(emb_names) != 2 or not any(
            "t_attn" in n for n in moved) or not any("t_norm" in n for n in moved):
        fail(f"options fine-tuning: frozen changed {unchanged[:3]}, not moved "
             f"{sorted(set(trained) - moved)[:3]}")
    if launches != want or not all(np.isfinite(r_["loss"]) for r_ in rows):
        fail(f"options fine-tuning launches {launches}, expected {want}; loss {rows}")
    del engine, bundle, frozen, trained, after, batches
    torch.cuda.empty_cache()

    # (c) the OpenCLIP ViT-H-14 towers, fp32, B=2, seeded random weights: card
    # against the same modules on the CPU
    torch.manual_seed(16)
    with torch.device(dev):
        text = FrozenOpenCLIPTextEmbedder(OpenClipTextTransformer(), layer="penultimate",
                                          legacy=False, always_return_pooled=True)
        vision = FrozenOpenCLIPImageEmbedder(OpenClipVisionTransformer(), output_tokens=True)
    n_text = sum(p_.numel() for p_ in text.parameters()) / 1e6
    n_vis = sum(p_.numel() for p_ in vision.parameters()) / 1e6
    ids = torch.as_tensor(rs.randint(1, 49406, (2, 77)))
    ids[0, 20:], ids[0, 19], ids[1, 76] = 0, 49407, 49407
    pics = torch.as_tensor(rs.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32))
    outs, ms = {}, {}
    for where in (dev, "cpu"):
        t_, v_ = (text, vision) if where == dev else (copy.deepcopy(text).cpu(),
                                                      copy.deepcopy(vision).cpu())
        outs[str(where)] = (*t_(ids.to(where)), *v_(pics.to(where)))
        if where == dev:
            ms["text"] = time_ms(lambda: t_(ids.to(dev)))
            ms["vision"] = time_ms(lambda: v_(pics.to(dev)))
        del t_, v_
    errs = [rel_l2(a_.cpu(), b_) for a_, b_ in zip(outs[str(dev)], outs["cpu"])]
    log(f"[options] OpenCLIP ViT-H-14 text tower ({n_text:.1f} M parameters, 24 × 1024, 77 "
        f"tokens, penultimate and EOT-pooled) {ms['text']:.3f} ms and vision tower "
        f"({n_vis:.1f} M, 32 × 1280, 256² resized to 224², tokens and pooled) {ms['vision']:.3f} ms "
        f"per call at B=2, fp32; card against CPU relative L2 {[f'{e_:.2e}' for e_ in errs]} "
        f"(tolerance 1e-3: cuDNN's conv1 in TF32)")
    if any(not (e_ <= 1e-3) for e_ in errs) or not all(
            torch.isfinite(o_).all() for o_ in outs[str(dev)]):
        fail("OpenCLIP towers: card and CPU disagree, or the output is not finite")
    del text, vision, outs
    torch.cuda.empty_cache()
    log(f"[options] phase 16 in {time.perf_counter() - t_phase:.1f} s")



def vae_gan(dev, card: str, kernel_fns, expected, by_path) -> float:
    """Phase 17: one ae_step and one disc_step, then two more of each for
    their times, on the shipped VAE (fp32) with taming's default
    discriminator and LPIPSAlex as the perceptual net, B=2 at 256², seeded
    weights. Returns the phase's seconds."""
    import numpy as np
    import torch

    from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2, randomize_parameters
    from udifftext_tpu_torch.diffusion import vae_loss
    from udifftext_tpu_torch.models.discriminator import NLayerDiscriminator
    from udifftext_tpu_torch.models.lpips import LPIPSAlex
    from udifftext_tpu_torch.models.vae import AutoencoderKL, DDConfig

    t_phase = time.perf_counter()
    vae_p = TEXTDESIGN_SD_2["first_stage_config"]["params"]
    dd = {k: (tuple(v) if isinstance(v, list) else v) for k, v in vae_p["ddconfig"].items()
          if k in {f.name for f in dataclasses.fields(DDConfig)}}
    torch.manual_seed(17)
    with torch.device(dev):
        vae = randomize_parameters(AutoencoderKL(DDConfig(**dd), vae_p["embed_dim"]), 17)
        disc = NLayerDiscriminator()  # taming's default: ndf 64, 3 layers
        lpips = randomize_parameters(LPIPSAlex(), 18).eval().requires_grad_(False)
    for m in lpips.modules():  # lpips' lin layers weigh squared differences: keep them positive
        if type(m).__name__ == "NetLinLayer":
            m.model[1].weight.data.abs_()

    def perceptual(a, b):
        return lpips(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))

    rs = np.random.RandomState(17)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32) / 256
    x = np.stack([np.sin(6 * xx + f_) * np.cos(4 * yy - f_) for f_ in rs.uniform(0, 3, (2, 3))
                  .reshape(-1)], -1).reshape(256, 256, 2, 3).transpose(2, 0, 1, 3)
    x = torch.as_tensor(np.clip(x + 0.05 * rs.standard_normal(x.shape), -1, 1)
                        .astype(np.float32), device=dev)
    with torch.no_grad():
        lat = vae.encode_moments(x).shape[:-1] + (vae_p["embed_dim"],)
    gen = torch.Generator(dev).manual_seed(17)
    eps = [torch.randn(lat, generator=gen, device=dev) for _ in range(3)]
    cfg = vae_loss.VAEGanLossConfig(disc_start=0, disc_weight=0.5, kl_weight=1e-6)
    ae_step, disc_step = vae_loss.make_vae_train_steps(
        cfg, vae, disc, torch.optim.Adam(vae.parameters(), lr=4.5e-6, betas=(0.5, 0.9)),
        torch.optim.Adam(disc.parameters(), lr=4.5e-6, betas=(0.5, 0.9)), perceptual)
    state = {"logvar": torch.zeros((), device=dev), "step": 0}

    def snap(module):
        return {k: v.detach().clone() for k, v in module.state_dict().items()}

    reset(*kernel_fns)
    held = torch.cuda.memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    vae0, disc0 = snap(vae), snap(disc)
    loss, log_ae = ae_step(state, x, eps[0])
    vae1, disc1 = snap(vae), snap(disc)
    d_loss, log_d = disc_step(state, x, eps[0])
    vae2, disc2 = snap(vae), snap(disc)
    still = [k for k in dict(vae.named_parameters()) if torch.equal(vae0[k], vae1[k])]
    disc_moved = [k for k in disc0 if not torch.equal(disc0[k], disc1[k])]
    vae_moved = [k for k in vae1 if not torch.equal(vae1[k], vae2[k])]
    disc_still = [k for k in dict(disc.named_parameters()) if torch.equal(disc1[k], disc2[k])]
    logs = {**log_ae, **log_d}
    bad = [k for k, v in logs.items() if not bool(torch.isfinite(v).all())]
    times = {"ae": [], "disc": []}
    for i in (1, 2):
        for name, step in (("ae", ae_step), ("disc", disc_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, x, eps[i])
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    launches = by_path["vae_gan"] = counts(*kernel_fns)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    n_vae = sum(p.numel() for p in vae.parameters()) / 1e6
    n_disc = sum(p.numel() for p in disc.parameters()) / 1e6
    log(f"[vae_gan] {card}: the shipped VAE ({n_vae:.1f} M parameters, fp32) against taming's "
        f"NLayerDiscriminator ({n_disc:.2f} M, ndf 64, 3 layers), LPIPSAlex perceptual, B=2, "
        f"256²: ae_step {[round(t_, 4) for t_ in times['ae']]} s, disc_step "
        f"{[round(t_, 4) for t_ in times['disc']]} s (steps 2 and 3; host clock to a "
        f"synchronize); peak device memory {peak:.2f} GiB ({held:.2f} GiB allocated before); "
        f"first step: loss {float(loss):.4f}, d_loss {float(d_loss):.4f}, "
        + ", ".join(f"{k.split('/')[-1]} {float(v):.4g}" for k, v in logs.items())
        + f"; launches {launches}")
    log(f"[vae_gan] ae_step: {len(vae0) - len(still)} of {len(dict(vae.named_parameters()))} "
        f"VAE parameters moved, {len(disc_moved)} discriminator tensors changed (parameters and "
        f"running statistics); disc_step: {len(vae_moved)} VAE tensors changed, "
        f"{len(disc_still)} discriminator parameters did not move, num_batches_tracked "
        f"{int(disc2['main.3.num_batches_tracked'])}")
    if bad or not bool(torch.isfinite(loss)) or not bool(torch.isfinite(d_loss)):
        fail(f"vae_gan: non-finite losses {bad}")
    if still or disc_moved or vae_moved or disc_still:
        fail(f"vae_gan: VAE still {still[:3]}, discriminator changed by ae_step {disc_moved[:3]}, "
             f"VAE changed by disc_step {vae_moved[:3]}, discriminator still {disc_still[:3]}")
    if int(disc2["main.3.num_batches_tracked"]) != 2 or launches != expected():
        fail(f"vae_gan: running statistics or launches {launches}")
    del vae, disc, lpips, state, vae0, vae1, vae2, disc0, disc1, disc2
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


STR_MODELS = ("parseq", "parseq-tiny", "vitstr", "abinet", "trba", "crnn")


def str_hub_phase(dev, card: str, kernel_fns, expected, by_path) -> float:
    """Phase 18: each STR hub model at its base configuration, fp32, on 64
    images of 32×128 (card against CPU on the first 4 rows, ms per
    forward), then one PARSeq-base permuted-training step. Returns the
    phase's seconds."""
    import numpy as np
    import torch

    from udifftext_tpu_torch.builders import randomize_parameters
    from udifftext_tpu_torch.models import parseq as pq
    from udifftext_tpu_torch.models.str_hub import build_model, create_model

    t_phase = time.perf_counter()
    rs = np.random.RandomState(18)
    yy, xx = np.mgrid[0:32, 0:128].astype(np.float32)
    imgs = np.stack([np.sin(xx / rs.uniform(2, 9) + rs.uniform(0, 6))[..., None]
                     * np.cos(yy / rs.uniform(2, 9))[..., None] * rs.uniform(-1, 1, 3)
                     for _ in range(64)]).astype(np.float32)
    imgs = np.clip(imgs + 0.1 * rs.standard_normal(imgs.shape), -1, 1).astype(np.float32)
    x = torch.as_tensor(imgs, device=dev)
    work = tempfile.TemporaryDirectory(prefix="udt_str_")
    paths = {}
    for i, name in enumerate(STR_MODELS):  # seeded strhub-layout files (`model.` prefix)
        src = randomize_parameters(build_model(name), 18 + i, keep=("localization_fc2.bias",))
        paths[name] = f"{work.name}/{name}.pt"
        torch.save({f"model.{k}": v for k, v in src.state_dict().items()}, paths[name])
    del src
    reset(*kernel_fns)
    for name in STR_MODELS:
        cpu = create_model(name, paths[name], device="cpu")
        card_m = create_model(name, paths[name], device=dev)
        with torch.no_grad():
            got = card_m(x)
            want = cpu(x[:4].cpu())
            ms = time_ms(lambda: card_m(x), reps=5)
        err = rel_l2(got[:4], want)
        agree = float((got[:4].argmax(-1).cpu() == want.argmax(-1)).float().mean())
        n_par = sum(p.numel() for p in cpu.parameters()) / 1e6
        log(f"[str] {card}: {name} ({n_par:.1f} M parameters, fp32) {ms:.3f} ms per forward of "
            f"64 images of 32×128 (CUDA events, median of 5), logits {tuple(got.shape)}; "
            f"card against CPU on 4 rows: relative L2 {err:.2e} (tolerance 1e-2: cuDNN convs in "
            f"TF32), greedy ids agree {agree:.3f}")
        if not bool(torch.isfinite(got).all()) or not err <= 1e-2:
            fail(f"STR model {name}: card and CPU disagree ({err}) or non-finite logits")
        del cpu, card_m, got
    torch.cuda.empty_cache()

    # one PARSeq-base permuted-training step: 6 orderings, backward, AdamW
    model = create_model("parseq", paths["parseq"], device=dev).train()
    work.cleanup()
    tok = pq.ParseqTokenizer()
    words = ["".join(rs.choice(list(pq.PARSEQ_CHARSET), rs.randint(1, 26))) for _ in range(64)]
    ids = torch.as_tensor(tok.encode(words, 25), device=dev)
    opt = torch.optim.AdamW(model.parameters(), lr=7e-4, weight_decay=0.0)
    secs = []
    for step in range(2):
        perms = pq.gen_tgt_perms(np.random.default_rng(step), 25, perm_num=6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = pq.parseq_training_loss(model, x, ids, perms)
        loss.backward()
        grads_ok = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
                       if p.grad is not None)
        opt.step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(loss)) or not grads_ok:
            fail(f"PARSeq training step {step}: loss {float(loss)}, gradients finite {grads_ok}")
    launches = by_path["str"] = counts(*kernel_fns)
    log(f"[str] PARSeq-base permuted-training step (B=64, 6 orderings, labels of 1-25 "
        f"characters, AdamW): {[round(s_, 4) for s_ in secs]} s (the first builds the cuBLAS "
        f"handles), loss {loss.item():.4f}, gradients finite; launches on the STR path "
        f"{launches}")
    if launches != expected():
        fail(f"the STR path launched a kernel: {launches}")
    del model, opt
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


def word_crops(rs, n: int) -> list:
    """`n` synthetic word crops as (uint8 (h, w, 3), label): heights 16-64,
    widths 40-400, stripes of two seeded colours under a few dark bars, and
    labels of 1-25 characters of PARSeq's charset."""
    import numpy as np

    from udifftext_tpu_torch.models.parseq import PARSEQ_CHARSET

    out = []
    for _ in range(n):
        h, w = rs.randint(16, 65), rs.randint(40, 401)
        t = (np.sin(np.arange(w) / rs.uniform(2, 12))[None, :, None] + 1) / 2
        img = t * rs.randint(0, 256, 3) + (1 - t) * rs.randint(0, 256, 3)
        img = np.broadcast_to(img, (h, w, 3)).copy()
        for x in rs.randint(0, w, rs.randint(1, 6)):
            img[h // 4:3 * h // 4, x:x + rs.randint(2, 8)] = rs.randint(0, 60)
        label = "".join(rs.choice(list(PARSEQ_CHARSET), rs.randint(1, 26)))
        out.append((img.astype(np.uint8), label))
    return out


def str_data_phase(dev, card: str, kernel_fns, expected, by_path) -> float:
    """Phase 19: the STR data path, tools and trainer. Returns the phase's
    seconds."""
    import numpy as np
    import torch

    from udifftext_tpu_torch.builders import randomize_parameters
    from udifftext_tpu_torch.data import lmdb_native
    from udifftext_tpu_torch.data.lmdb import LMDBReader, write_lmdb
    from udifftext_tpu_torch.models.str_hub import build_model, create_model
    from udifftext_tpu_torch.scripts import (
        str_abinet_lm_acc,
        str_bench,
        str_read,
        str_test,
        str_train,
    )
    from udifftext_tpu_torch.utils.png import encode_png

    t_phase = time.perf_counter()
    rs = np.random.RandomState(19)
    work = tempfile.TemporaryDirectory(prefix="udt_str19_")
    root = work.name

    def write_set(path, samples):
        items = {b"num-samples": str(len(samples)).encode()}
        for i, (img, label) in enumerate(samples, start=1):
            items[b"image-%09d" % i] = encode_png(img)
            items[b"label-%09d" % i] = label.encode()
        write_lmdb(path, items)

    t0 = time.perf_counter()
    train_dir = f"{root}/train"
    write_set(train_dir, word_crops(rs, 2048))
    bench_sets = ("IIIT5k", "SVT", "IC13_857")
    for name in bench_sets:
        write_set(f"{root}/bench/{name}", word_crops(rs, 256))
    mib = os.path.getsize(f"{train_dir}/data.mdb") / 2**20
    log(f"[str19] wrote 2048 word crops ({mib:.1f} MiB) and 3 benchmark sets of 256 as "
        f"encode_png PNGs through write_lmdb in {time.perf_counter() - t0:.2f} s")

    # both readers over every key of the training set: records/s, bytes equal
    keys = [b"%s-%09d" % (kind, i) for i in range(1, 2049) for kind in (b"image", b"label")]
    try:
        native = lmdb_native.NativeLMDBReader(train_dir)
    except RuntimeError as e:
        fail(f"the native LMDB reader did not build: {e}")
    rates, values = {}, {}
    for name, reader in (("native", native), ("python", LMDBReader(train_dir))):
        with reader as db:
            t0 = time.perf_counter()
            values[name] = [db.get(k) for k in keys]
            rates[name] = len(keys) / (time.perf_counter() - t0)
    if values["native"] != values["python"] or any(v is None for v in values["native"]):
        fail("the native and Python LMDB readers disagree")
    log(f"[str19] LMDB get over {len(keys)} records: native {rates['native']:.0f} records/s, "
        f"Python {rates['python']:.0f} records/s (host clock)")

    # str_train at PARSeq-base width from the LMDB (the native reader, host PNG
    # decode, bicubic_resize on the card): B=64, 40 steps, SWA from step 31
    items = str_test.load_folder(train_dir)  # open_lmdb: the native reader, built above
    if len(items) != 2048:
        fail(f"str_test.load_folder gave {len(items)} LMDB items")
    model = randomize_parameters(build_model("parseq"), 19).to(dev)
    n_par = sum(p.numel() for p in model.parameters()) / 1e6
    lo, hi = {}, {}

    def track(i, m):  # each snapshot's range, over the steps SWA averages
        if i >= 30:
            with torch.no_grad():
                for k, p in m.named_parameters():
                    lo[k] = p.detach().clone() if k not in lo else torch.minimum(lo[k], p)
                    hi[k] = p.detach().clone() if k not in hi else torch.maximum(hi[k], p)

    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    reset(*kernel_fns)
    res = str_train.train(items, model, dev, np.random.default_rng(0), steps=40, batch=64,
                          swa=True, swa_start_pct=0.75, log=lines.append, on_step=track)
    launches = by_path["str_train"] = counts(*kernel_fns)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in lines:
        log(f"[str19] {line}")
    step_med = statistics.median(res.step_s[1:])
    host = sum(res.host_s[1:]) / sum(res.step_s[1:])
    log(f"[str19] {card}: str_train PARSeq-base ({n_par:.1f} M parameters, fp32), B=64, 40 steps, "
        f"6 orderings, one-cycle lr 7e-4, clip 20, AdamW: {step_med:.4f} s/step (median of steps "
        f"2-40; step 1 {res.step_s[0]:.3f} s), {64 / step_med:.1f} samples/s, host share "
        f"{host:.3f} (LMDB get + PNG decode + resize queued: {statistics.median(res.host_s[1:]):.4f}"
        f" s a step), peak {peak:.2f} GiB ({held:.2f} held before), losses "
        f"{[round(x, 4) for x in res.losses[::8]]}; launches {launches}")
    if not all(np.isfinite(res.losses)):
        fail(f"str_train: non-finite loss {res.losses}")
    if res.swa_n != 10 or lines[-1] != "swa: averaged 10 snapshots from step 31":
        fail(f"str_train SWA: {res.swa_n} snapshots, {lines[-1:]}")
    outside = [k for k in lo if not bool(((res.state_dict[k] >= lo[k] - 1e-6 * lo[k].abs())
                                          & (res.state_dict[k] <= hi[k] + 1e-6 * hi[k].abs()))
                                         .all())]
    if outside or len(lo) != len(dict(model.named_parameters())):
        fail(f"SWA average outside its snapshots' range: {outside[:5]}")
    if launches != expected():
        fail(f"the STR trainer launched a kernel: {launches}")
    # the host's batch in two parts: LMDB get + PNG decode, then load_crop
    # (the copy to the card, the resize weights built in numpy, the resize)
    t0 = time.perf_counter()
    imgs = [items[j][0]() for j in range(64)]
    t1 = time.perf_counter()
    crops = [str_test.load_crop(im, (32, 128), dev) for im in imgs]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[str19] a batch of 64 on the host: LMDB get + PNG decode {t1 - t0:.4f} s, load_crop "
        f"{t2 - t1:.4f} s (host clock, ending in a synchronize)")
    del imgs, crops
    ckpt = str_train.save_checkpoint(res.state_dict, f"{root}/ckpt", 40)
    del model, lo, hi, res
    try:
        loaded = create_model("parseq", ckpt, device=dev)
    except RuntimeError as e:
        fail(f"the STR trainer's checkpoint does not load strictly: {e}")
    del loaded
    torch.cuda.empty_cache()

    # str_test on the checkpoint, str_bench, str_read, str_abinet_lm_acc
    reset(*kernel_fns)
    t0 = time.perf_counter()
    results = str_test.main(["--data_root", f"{root}/bench", "--ckpt", ckpt, "--batch", "64"])
    test_s = time.perf_counter() - t0
    n_read = sum(r.num_samples for r in results.values())
    if sorted(results) != sorted(bench_sets) or not os.path.exists(ckpt + ".log.txt"):
        fail(f"str_test: sets {sorted(results)}, log written {os.path.exists(ckpt + '.log.txt')}")
    log(f"[str19] str_test --ckpt: {n_read} images of {len(results)} sets in {test_s:.2f} s, "
        f"{n_read / test_s:.1f} images/s (host clock, model load included)")
    bench = str_bench.main(["parseq", "64"])
    pngs = []
    for i, (img, _) in enumerate(word_crops(rs, 2)):
        pngs.append(f"{root}/read{i}.png")
        with open(pngs[-1], "wb") as f:
            f.write(encode_png(img))
    texts = str_read.main(pngs + ["--ckpt", ckpt])
    abinet = randomize_parameters(build_model("abinet"), 19)
    abinet_path = f"{root}/abinet.pt"
    torch.save({f"model.{k}": v for k, v in abinet.state_dict().items()}, abinet_path)
    lm = str_abinet_lm_acc.main(["--data_root", f"{root}/bench", "--ckpt", abinet_path])
    launches = by_path["str_tools"] = counts(*kernel_fns)
    log(f"[str19] str_bench parseq 64: {bench['ms']:.3f} ms per forward, "
        f"{bench['images_per_s']:.1f} images/s, {bench['gflops']:.1f} GFLOPs; str_read "
        f"{len(texts)} files; str_abinet_lm_acc {sorted(lm)}; launches {launches}")
    if (len(texts) != 2 or not bench["ms"] > 0 or sorted(lm) != ["IIIT5k", "SVT"]
            or launches != expected()):
        fail(f"STR tools: {texts}, {bench}, {sorted(lm)}, launches {launches}")
    work.cleanup()
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port, whose `launches` the phases count."""
    from udifftext_tpu_torch.ops.cross_attention import fused_cross_attention
    from udifftext_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from udifftext_tpu_torch.ops.flash_variants import flash_variant
    from udifftext_tpu_torch.ops.geglu import geglu_ff, geglu_ff_ln
    from udifftext_tpu_torch.ops.groupnorm import fused_groupnorm_silu
    from udifftext_tpu_torch.ops.ln_gemm import ln_gemm, ln_gemm3

    return (flash_attention, flash_attention_bwd, geglu_ff, ln_gemm, ln_gemm3,
            fused_cross_attention, geglu_ff_ln, fused_groupnorm_silu, flash_variant)


# phases 20-21: configs/demo.yaml's sampler for the dp-2 service, one bucket of 8
# (4 rows a rank); the tensor-parallel step's micro-batch, seed and LR
DP_SERVE = {"load_ckpt_path": None, "bf16": True, "H": 512, "seq_len": 12, "steps": 50,
            "scale": [4.0, 0.0], "noise_iters": 10}
DP_BUCKET = 8
TP_MICRO, TP_SEED, TP_LR = 8, 21, 5e-5


def dp_requests() -> list:
    """DP_BUCKET distinct 512² uint8 requests: seeded noise images, masks of
    different boxes, different words."""
    import numpy as np

    from udifftext_tpu_torch.serving import InpaintRequest

    rs = np.random.RandomState(20)
    out = []
    for i, word in enumerate(("HELLO", "card", "Two", "ranks", "serve", "one", "BUCKET", "ok")):
        mask = np.zeros((512, 512), np.uint8)
        y0, x0 = 64 + 24 * i, 48 + 16 * i
        mask[y0:y0 + 128, x0:x0 + 256] = 1
        out.append(InpaintRequest(image=rs.randint(0, 256, (512, 512, 3)).astype(np.uint8),
                                  mask=mask, text=word))
    return out


def tp_step(engine, dev, data_group=None):
    """One fine-tuning step of TP_MICRO synthetic 512² samples (one
    micro-batch) with the draws of a generator seeded TP_SEED: (loss, state,
    seconds)."""
    import torch

    from udifftext_tpu_torch.data.synthetic import SyntheticBatches
    from udifftext_tpu_torch.parallel import train as PT
    from udifftext_tpu_torch.train import to_device

    batch = to_device(SyntheticBatches(1, TP_MICRO, seed=TP_SEED).batches[0], dev)
    state = PT.TrainState.create(engine, base_lr=TP_LR, steps_per_epoch=1000)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    loss, _ = PT.train_step(
        state, [batch],
        lambda mb: engine.loss(mb, generator=torch.Generator(dev).manual_seed(TP_SEED)),
        data_group=data_group)
    loss = float(loss)
    return loss, state, time.perf_counter() - t0


def multicard_child(work: str) -> None:
    """One rank of phases 20-21 (started by `multicard_phases` with torchrun's
    variables): the dp-2 service (rank 0 serves DP_BUCKET requests and shuts
    down, rank 1 serves until the stop header), then the tensor-parallel
    step over the world as one tensor group. Each phase prints a JSON line;
    results go to `work`."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2, TEXTDESIGN_SD_2_TRAIN, build_engine
    from udifftext_tpu_torch.builders import randomize_parameters
    from udifftext_tpu_torch.ops import _build
    from udifftext_tpu_torch.parallel import dist, sharding
    from udifftext_tpu_torch.parallel.mesh import make_groups
    from udifftext_tpu_torch.scripts import serve

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    if os.environ["MULTICARD_BACKEND"] == "gloo":  # ranks that share a card
        tdist.init_process_group("gloo", init_method="env://", timeout=dist.group_timeout())
    else:
        dist.maybe_init_distributed(dev)
    _build.load_library()
    kernel_fns = kernel_wrappers()

    # 20. the dp-2 service
    reset(*kernel_fns)
    torch.cuda.reset_peak_memory_stats(dev)
    svc = serve.build_service(DP_SERVE, TEXTDESIGN_SD_2, dev, max_batch=DP_BUCKET,
                              buckets=(DP_BUCKET,), pipeline=2, dp=world, seed=0,
                              noise_search_batched=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if rank == 0:
        res = [f.result(timeout=600) for f in [svc.submit(r) for r in dp_requests()]]
        run = svc.predictor.run
        svc.shutdown()
        np.savez(f"{work}/dp2.npz", images=np.stack([r["image"] for r in res]),
                 scores=run.last_aux["noise_scores"].float().cpu().numpy(),
                 coords=np.array([(r["batch_key"], r["row"], r["batch_size"]) for r in res]))
        groups = svc.predictor.groups
    else:
        groups = svc.serve()
        run = svc.run
    torch.cuda.synchronize(dev)
    print(json.dumps({"phase": 20, "rank": rank, "groups": groups, "launches": counts(*kernel_fns),
                      "scores": run.last_aux["noise_scores"].float().cpu().tolist(),
                      "s": time.perf_counter() - t0,
                      "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}), flush=True)
    del svc, run  # the engine goes with them, before phase 21's peak is read
    torch.cuda.empty_cache()

    # 21. the tensor-parallel fine-tuning step
    grid = make_groups(1, world)
    engine = build_engine(TEXTDESIGN_SD_2_TRAIN, torch.bfloat16, dev, train=True).engine
    randomize_parameters(engine, 0)
    plan = sharding.shard_model_(engine, grid.tensor)
    reset(*kernel_fns)
    torch.cuda.reset_peak_memory_stats(dev)
    loss, state, step_s = tp_step(engine, dev, grid.data)
    torch.save({"loss": loss,
                "params": {n: p.detach().cpu() for n, p in state.params.items()},
                "grads": {n: p.grad.detach().cpu() for n, p in state.params.items()}},
               f"{work}/tp.{rank}.pt")
    print(json.dumps({"phase": 21, "rank": rank, "loss": loss, "s": step_s,
                      "launches": counts(*kernel_fns), "whole": plan.whole,
                      "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}), flush=True)
    tdist.destroy_process_group()


def multicard_phases(dev, card: str, kernel_fns, expected, by_path) -> float:
    """Phases 20-21: two ranks (`multicard_child`) against one process in
    this one. Returns the phases' seconds."""
    import numpy as np
    import torch

    from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2, TEXTDESIGN_SD_2_TRAIN, build_engine
    from udifftext_tpu_torch.builders import randomize_parameters
    from udifftext_tpu_torch.parallel import sharding
    from udifftext_tpu_torch.predict import Predictor
    from udifftext_tpu_torch.scripts import serve
    from udifftext_tpu_torch.serving import batch_seed

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with what earlier phases cached
    share = torch.cuda.device_count() < 2
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[multicard] {card}; compute mode {mode}: "
        + ("one card, so both ranks run on cuda:0 with gloo (an explicit choice of this "
           "smoke run: their times share the card and are not a speed-up figure)"
           if share else "two ranks on cuda:0 and cuda:1 with NCCL"))
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="udt_multicard_") as work:
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                   MULTICARD_BACKEND="gloo" if share else "nccl")
        here = os.path.dirname(os.path.abspath(__file__))
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multicard-rank",
                                   work], cwd=here, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=dict(env, RANK=str(r), LOCAL_RANK="0" if share else str(r)))
                 for r in range(2)]
        try:
            # 20, this process: the dp-1 service on the same seed and requests
            reset(*kernel_fns)
            svc = serve.build_service(DP_SERVE, TEXTDESIGN_SD_2, dev,
                                      max_batch=DP_BUCKET, buckets=(DP_BUCKET,), pipeline=2,
                                      seed=0, noise_search_batched=True)
            t0 = time.perf_counter()
            res = [f.result(timeout=600) for f in [svc.submit(r) for r in dp_requests()]]
            one_s = time.perf_counter() - t0
            one_scores = svc.predictor.last_aux["noise_scores"].float().cpu().numpy()
            svc.shutdown()
            one_launches = counts(*kernel_fns)
            one_images = np.stack([r["image"] for r in res])
            one_coords = [(r["batch_key"], r["row"], r["batch_size"]) for r in res]
            group = svc.batch_of([svc.build_row(r) for r in dp_requests()])
            one_engine = svc.predictor.predictor.engine
            del svc, res
            # 21, this process: the unsharded step from the same weights and draws
            engine = build_engine(TEXTDESIGN_SD_2_TRAIN, torch.bfloat16, dev, train=True).engine
            randomize_parameters(engine, 0)
            start = {n: p.detach().cpu().clone() for n, p in engine.named_parameters()
                     if p.requires_grad}
            plan = sharding.tp_plan(engine, 2)
            unet_sd = engine.state_dict()
            shards = [sharding.shard_state_dict(unet_sd, t_, 2, plan) for t_ in range(2)]
            round_trip = sharding.gather_state_dict(shards, plan)
            bit_equal = all(torch.equal(round_trip[k], v) for k, v in unet_sd.items())
            del shards, round_trip, unet_sd
            ref_loss, ref_state, ref_s = tp_step(engine, dev)
            ref = {n: (p.detach().cpu(), p.grad.detach().cpu())
                   for n, p in ref_state.params.items()}
            del engine, ref_state
            torch.cuda.empty_cache()
            outs = [p_.communicate(timeout=900) for p_ in procs]
            # 20: where the two chose different candidates, this process samples
            # the group again from the dp-2 one (its draws, no search)
            dp2 = dict(np.load(f"{work}/dp2.npz"))
            chosen = int(np.argmin(dp2["scores"]))
            same_images = one_images
            if chosen != int(np.argmin(one_scores)):
                g_ = torch.Generator(dev).manual_seed(batch_seed(0, 0))
                shape = (DP_BUCKET, 64, 64, 4)
                eps = torch.randn(shape, generator=g_, device=dev)
                cands = torch.randn((DP_SERVE["noise_iters"],) + shape, generator=g_, device=dev)
                again = Predictor(one_engine, num_steps=DP_SERVE["steps"],
                                  cfg_scale=DP_SERVE["scale"][0], noise_iters=0)
                same_images = again(group, posterior_eps=eps,
                                    noise=cands[chosen][None])[0].cpu().numpy()
                del again, eps, cands
            del one_engine
            torch.cuda.empty_cache()
        finally:
            for p_ in procs:
                if p_.poll() is None:
                    p_.kill()
                    p_.wait()
        lines = {}
        for r, (p_, (out, err)) in enumerate(zip(procs, outs)):
            if p_.returncode != 0:
                fail(f"multicard rank {r} exited {p_.returncode}:\n{err[-4000:]}")
            for line in out.splitlines():
                if line.startswith('{"phase"'):
                    rec = json.loads(line)
                    lines[(rec["phase"], rec["rank"])] = rec
        if set(lines) != {(ph, r) for ph in (20, 21) for r in range(2)}:
            fail(f"multicard ranks printed {sorted(lines)}")
        tp_parts = [torch.load(f"{work}/tp.{r}.pt") for r in range(2)]

    # 20: the dp-2 service against the dp-1 one. The candidates' scores are
    # sums over the bucket that the two add in another order, through kernels
    # and cuBLAS products whose plans depend on the rows: where the lowest
    # differ by less than twice the scores' measured disagreement, the choice
    # is a tie at the rounding level, and the images are held to this
    # process's sampling of the dp-2 candidate. Both ranks must hold the same
    # global scores, bit for bit (one all-reduce), and so choose alike.
    one_choice = int(np.argmin(one_scores))
    order = np.argsort(one_scores)
    gap = float(one_scores[order[1]] - one_scores[order[0]])
    spread = (one_scores[order] - one_scores[order[0]]).tolist()
    score_err = float(np.abs(dp2["scores"] - one_scores).max())
    score_tol = 1e-4 * float(np.abs(one_scores).max())
    tie_tol = 2 * score_err
    n_tied = sum(d <= tie_tol for d in spread)
    tied = chosen != one_choice and one_scores[chosen] - one_scores[one_choice] <= tie_tol
    ranks_agree = (lines[(20, 0)]["scores"] == lines[(20, 1)]["scores"]
                   == dp2["scores"].tolist())
    diff = np.abs(dp2["images"].astype(np.int32) - same_images.astype(np.int32))
    img_err = float(np.linalg.norm(diff) / np.linalg.norm(same_images.astype(np.float64)))
    within1 = float((diff <= 1).mean())
    per_group = expected(flash_attention=520, geglu_ff=780)
    log(f"[dp_serve] {card}: a bucket of {DP_BUCKET} (50 steps, CFG 4.0, 10 candidates in the "
        f"batched search, 512² uint8) on 2 ranks ({DP_BUCKET // 2} rows each) against one "
        f"process: global scores max abs diff {score_err:.3e} (tolerance {score_tol:.3e}, 1e-4 "
        f"of the largest), the two ranks' global scores bit-equal {ranks_agree}, chosen "
        f"candidate {chosen} / {one_choice}, gap between the two lowest {gap:.4e}; the 10 "
        f"scores above the lowest (one process) {['%.3e' % d for d in spread]}, {n_tied} of "
        f"them within the tie tolerance {tie_tol:.3e} (twice the measured disagreement)"
        + (f" (a tie: the images below are against this process's sampling of candidate "
           f"{chosen} from the same draws)" if tied else "")
        + f"; images relative L2 {img_err:.3e} (tolerance 5e-2, phase 5b's: the kernels' and "
        f"cuBLAS's plans depend on the rows), max abs {int(diff.max())}, share within one uint8 "
        f"step {within1:.4f}; replay coordinates equal "
        f"{dp2['coords'].tolist() == [list(c) for c in one_coords]}")
    for r in range(2):
        rec = lines[(20, r)]
        log(f"[dp_serve] rank {r}: {rec['groups']} group(s) in {rec['s']:.2f} s, peak device memory "
            f"{rec['peak_gib']:.2f} GiB (reset counter), launches {rec['launches']}")
    log(f"[dp_serve] one process: the group in {one_s:.2f} s, launches {one_launches} (the two "
        f"ranks shared the card with this process: no time here is a speed-up figure)")
    by_path["dp_serve"] = lines[(20, 0)]["launches"]
    if (img_err > 5e-2 or score_err > score_tol or not ranks_agree
            or (chosen != one_choice and not tied)
            or dp2["coords"].tolist() != [list(c) for c in one_coords]
            or any(lines[(20, r)]["launches"] != per_group for r in range(2))
            or one_launches != per_group or [lines[(20, r)]["groups"] for r in range(2)] != [1, 1]):
        fail("phase 20: the dp-2 service disagrees with one process (images, scores or the "
             "candidate), the ranks' global scores differ, a rank launched other than 520 flash "
             "and 780 GEGLU kernels, or the worker did not end at shutdown")

    # 21: the tensor-parallel step against the unsharded one
    tp_loss = lines[(21, 0)]["loss"]
    loss_err = abs(tp_loss - ref_loss) / abs(ref_loss)
    g_diff = g_norm = 0.0
    beyond = excess = 0
    rep_diff = 0.0
    for n, (p_ref, g_ref) in ref.items():
        key = n
        if key in plan.rules:
            g_tp = sharding.gather_tensor([t_["grads"][n] for t_ in tp_parts], plan.rules[key])
            p_tp = sharding.gather_tensor([t_["params"][n] for t_ in tp_parts], plan.rules[key])
        else:  # replicated: rank 1's gradient and update are rank 0's
            g_tp, p_tp = tp_parts[0]["grads"][n], tp_parts[0]["params"][n]
            rep_diff = max(rep_diff, float((tp_parts[1]["grads"][n].float() - g_tp.float())
                                           .abs().max()),
                           float((tp_parts[1]["params"][n].float() - p_tp.float()).abs().max()))
        g_tp, g_ref = g_tp.double(), g_ref.double()
        g_diff += float((g_tp - g_ref).square().sum())
        g_norm += float(g_ref.square().sum())
        d_ = (p_tp.double() - p_ref.double()).abs()
        decided = 2 * TP_LR * torch.clamp((g_tp - g_ref).abs() / g_ref.abs().clamp_min(1e-8),
                                          max=1)
        beyond += int((d_ > 1e-6).sum())
        excess += int((d_ > 1e-6 + decided).sum())
    grad_err = (g_diff / g_norm) ** 0.5
    moved = sum(not torch.equal(tp_parts[0]["params"][n], sharding.shard_tensor(
        start[n], plan.rules[n], 0, 2) if n in plan.rules else start[n]) for n in ref)
    whole = lines[(21, 0)]["whole"]
    ds1 = [f"unet.{b_}.1.transformer_blocks.0.{a_}" for b_ in
           ("input_blocks.1", "input_blocks.2", "output_blocks.9", "output_blocks.10",
            "output_blocks.11") for a_ in ("attn1", "t_attn")]
    per_micro = expected(flash_attention=10, flash_attention_bwd=9, geglu_ff=15)
    log(f"[tp_train] {card}: one step of {TP_MICRO} synthetic 512² samples at tensor degree 2 "
        f"(TEXTDESIGN_SD_2_TRAIN, bf16, fp32 master weights, seeded weights and draws) against "
        f"the unsharded step: loss {tp_loss:.6f} / {ref_loss:.6f}, relative error {loss_err:.2e} "
        f"(tolerance 1e-2: bf16 partial sums added once more per row-parallel product); "
        f"trainable gradients' relative L2 {grad_err:.3e} (tolerance 5e-2); updated parameters: "
        f"{beyond} elements differ by more than 1e-6, {excess} by more than their gradients' "
        f"disagreement lets Adam's first step differ (tolerance 0); {moved} of {len(ref)} "
        f"trainable tensors moved; replicated gradients' and updated parameters' largest "
        f"difference between the two ranks {rep_diff:.3e} (tolerance 0); shard then gather of the state dict bit-equal {bit_equal}; kept "
        f"whole (tp_report): {len(whole)} modules {whole}")
    for r in range(2):
        rec = lines[(21, r)]
        log(f"[tp_train] rank {r}: the step in {rec['s']:.2f} s, peak device memory "
            f"{rec['peak_gib']:.2f} GiB (reset counter), launches {rec['launches']} (predicted "
            f"per micro-batch {per_micro})")
    log(f"[tp_train] the unsharded step in this process {ref_s:.2f} s (shared card: not a "
        f"speed-up figure)")
    by_path["tp_train"] = lines[(21, 0)]["launches"]
    if (loss_err > 1e-2 or grad_err > 5e-2 or excess or moved != len(ref) or not bit_equal
            or rep_diff != 0 or sorted(whole) != sorted(ds1)
            or any(lines[(21, r)]["launches"] != per_micro for r in range(2))):
        fail("phase 21: the tensor-parallel step disagrees with the unsharded one, or the two "
             "ranks' replicated gradients or updates differ, or the launches or tp_report "
             "are not the predicted ones")
    return time.perf_counter() - t_phase


PROBE_LIMIT_S = 120  # phase 22's time limit


def probes_phase(dev, card: str, kernel_fns, expected, by_path) -> float:
    """Phase 22: the nine stage and floor probes of udifftext_tpu_torch/scripts
    through their entry functions at full width (the shipped graph, the JAX
    scripts' shapes and step counts; 1 sample, or 2 UNet rows, and one timed
    call after a warm-up), each module released before the next. It fails on
    a missing label, a time that is not finite and positive, inline and
    hoisted K/V outputs that are not bit-equal (the same products on the same
    operands in the same order), a GEGLU plan that disagrees with the plain
    version, a whole `engine.sample` whose image is not bit-equal to the
    composed stages', a pipeline count that is not the steps' plus the K/V
    hoist's plus the decode's, or launch counts other than the UNet's plan,
    the wrappers' shape gates and the sweep's plans predict. The sweep calls
    the GEGLU entry directly for each plan; those launches are its own path,
    `probes_sweep_entry`, beside `probes`. Returns its seconds."""
    import gc
    import math

    import torch

    from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2, build_engine
    from udifftext_tpu_torch.models.attention import geglu_shape_ok
    from udifftext_tpu_torch.ops.attention import flash_shape_ok
    from udifftext_tpu_torch.ops.geglu import geglu_plan
    from udifftext_tpu_torch.scripts import (geglu_sweep, kv_hoist_probe, perf_probe,
                                             pipeline_probe, profile_components,
                                             profile_transformer, step_floor_probe,
                                             test_parity_probe, train_probe)

    t_phase = time.perf_counter()
    unet = build_engine(TEXTDESIGN_SD_2, torch.bfloat16, "meta").engine.unet  # the plan only
    (ef, eg), (df, dg) = plan_launches(unet, 64)
    fl, ge = ef + df, eg + dg  # one UNet eval: 10 flash, 15 GEGLU
    layers = step_floor_probe.layer_list(unet, 64)
    depth = unet.transformer_depth
    lay_fl = sum(depth * flash_shape_ok(x.side**2, x.side**2, x.dim_head) for x in layers)
    lay_ge = sum(depth * geglu_shape_ok(x.side**2) for x in layers)
    reps, runs = 1, 1
    calls = 1 + reps * runs  # per timed label: a warm-up, then the timed calls
    steps, cands = pipeline_probe.STEPS, test_parity_probe.TEST_RUN["noise_iters"]
    sample_evals = 2 * cands + steps  # the sequential search's rollouts, then the steps
    kw = dict(reps=reps, runs=runs, device=str(dev))
    m_sweep = 32 * 4096
    sweep = [geglu_sweep.plan_label(p, geglu_plan(torch.bfloat16, m_sweep, 320, 1280,
                                                  torch.cuda.get_device_properties(dev)
                                                  .multi_processor_count))
             for p in geglu_sweep.mma_plans(m_sweep, 320, 1280)]
    # name, call, labels, launches; the flash backward with every gradient
    # reaches each of the `fl` self-attentions, with the trainable ones all
    # but the first (its q/k/v sit upstream of every t_attn): PERF.md §6, the probes
    probes = (
        ("profile_components", lambda: profile_components.run(batch=2, **kw),
         profile_components.labels(), expected(flash_attention=(2 * fl + 3) * calls,
                                               geglu_ff=2 * ge * calls)),
        ("profile_transformer", lambda: profile_transformer.run(batch=1, **kw),
         profile_transformer.LABELS, expected(flash_attention=3 * calls, geglu_ff=2 * calls)),
        ("kv_hoist_probe", lambda: kv_hoist_probe.run(batch=1, **kw),
         kv_hoist_probe.LABELS + kv_hoist_probe.DIFF_LABELS,
         expected(flash_attention=fl * (2 * calls + 2), geglu_ff=ge * (2 * calls + 2))),
        ("step_floor_probe", lambda: step_floor_probe.run(batch=1, **kw),
         tuple(step_floor_probe.layer_label(x) for x in layers)
         + (step_floor_probe.STEP, step_floor_probe.REST, step_floor_probe.DECODE),
         expected(flash_attention=(lay_fl + fl) * calls, geglu_ff=(lay_ge + ge) * calls)),
        ("train_probe", lambda: train_probe.run(batch=1, **kw), train_probe.LABELS,
         expected(flash_attention=4 * fl * calls, geglu_ff=4 * ge * calls,
                  flash_attention_bwd=(fl + fl - 1) * calls)),
        ("pipeline_probe", lambda: pipeline_probe.run(batch=1, **kw), pipeline_probe.LABELS,
         expected(flash_attention=3 * steps * fl * calls, geglu_ff=3 * steps * ge * calls)),
        ("perf_probe", lambda: perf_probe.run(batch=1, **kw),
         perf_probe.labels() + (perf_probe.COUNT_GAP,),
         expected(flash_attention=(fl + 3) * calls + steps * fl * (1 + runs),
                  geglu_ff=ge * calls + steps * ge * (1 + runs))),
        ("test_parity_probe", lambda: test_parity_probe.run(batch=1, **kw),
         test_parity_probe.LABELS + (test_parity_probe.DIFF_LABEL,),
         expected(flash_attention=fl * ((steps + 2 * cands + sample_evals) * calls
                                        + 2 * sample_evals),
                  geglu_ff=ge * ((steps + 2 * cands + sample_evals) * calls
                                 + 2 * sample_evals))),
        ("geglu_sweep", lambda: geglu_sweep.run(**kw),
         tuple(sweep) + (geglu_sweep.WRAPPER, geglu_sweep.COMPOSITION, geglu_sweep.PRODUCTS),
         expected(geglu_ff=calls)),
    )
    checks = {  # the labels that hold no time, and the bound each must keep
        kv_hoist_probe.DIFF_LABELS[0]: 0.0, kv_hoist_probe.DIFF_LABELS[1]: 0.0,
        test_parity_probe.DIFF_LABEL: 0.0, perf_probe.COUNT_GAP: 0.0,
    }
    total = dict.fromkeys(counts(*kernel_fns), 0)
    geglu_sweep.launch.launches = 0
    for name, call, labels, want in probes:
        t0 = time.perf_counter()
        reset(*kernel_fns)
        got = call()
        torch.cuda.synchronize()
        launches = counts(*kernel_fns)
        total = {k: total[k] + n for k, n in launches.items()}
        log(f"[probes] {name}: {len(got)} labels in {time.perf_counter() - t0:.1f} s "
            f"({card}); launches {launches}")
        if set(got) != set(labels):
            fail(f"probe {name}: labels {sorted(set(labels) ^ set(got))} missing or extra")
        for label, v in got.items():
            if label in checks:
                if not abs(v) <= checks[label]:
                    fail(f"probe {name}: {label} = {v} (bound {checks[label]})")
            elif label == step_floor_probe.REST:
                if not math.isfinite(v):
                    fail(f"probe {name}: {label} = {v}")
            elif not (math.isfinite(v) and v > 0):
                fail(f"probe {name}: {label} took {v} ms (a failed GEGLU plan reads NaN)")
        if launches != want:
            fail(f"probe {name}: launches {launches}, expected {want}")
        del got
        gc.collect()
        torch.cuda.empty_cache()
    by_path["probes"] = total
    direct = geglu_sweep.launch.launches
    log(f"[probes] geglu_sweep: {direct} launches of the GEGLU entry with an explicit plan "
        f"(path probes_sweep_entry), expected {len(sweep)} plans x {1 + calls}")
    if direct != len(sweep) * (1 + calls):  # each plan's check, then its timed label
        fail(f"probe geglu_sweep: {direct} direct launches, expected {len(sweep) * (1 + calls)}")
    by_path["probes_sweep_entry"] = {**dict.fromkeys(total, 0), "geglu_ff": direct}
    return time.perf_counter() - t_phase


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the GPU")
    import numpy as np

    from udifftext_tpu_torch import demo, loading
    from udifftext_tpu_torch.builders import (
        TEXTDESIGN_SD_2,
        TEXTDESIGN_SD_2_TRAIN,
        build_engine,
        randomize_parameters,
    )
    from udifftext_tpu_torch.data.synthetic import SyntheticBatches
    from udifftext_tpu_torch.models.attention import (
        BasicTransformerBlock,
        GEGLUFeedForward,
        SpatialTransformer,
    )
    from udifftext_tpu_torch.models.layers import cast_weights
    from udifftext_tpu_torch.models.parseq import PARSeq
    from udifftext_tpu_torch.ocr import ParseqPredictor
    from udifftext_tpu_torch.ops import _build
    from udifftext_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_ref,
        flash_kernel_route,
    )
    from udifftext_tpu_torch.ops.cross_attention import (
        cross_attention_plan,
        fused_cross_attention,
        fused_cross_attention_ref,
    )
    from udifftext_tpu_torch.ops.flash_variants import (
        CLAMP_EXP,
        CLAMP_V1,
        TILE_MENU,
        VARIANTS,
        flash_v1_with_lse,
        flash_variant,
        flash_variant_ref,
        kernel_route,
        smem_bytes,
    )
    from udifftext_tpu_torch.ops.geglu import (
        geglu_ff,
        geglu_ff_ln,
        geglu_ff_ln_ref,
        geglu_ff_ref,
        geglu_kernel_route,
    )
    from udifftext_tpu_torch.ops.groupnorm import (
        fused_groupnorm_silu,
        fused_groupnorm_silu_ref,
        groupnorm_plan,
    )
    from udifftext_tpu_torch.ops.ln_gemm import (
        MMA_WIDTHS,
        ln_gemm,
        ln_gemm3,
        ln_gemm3_ref,
        ln_gemm_block_columns,
        ln_gemm_plan,
        ln_gemm_ref,
    )
    from udifftext_tpu_torch.predict import Predictor
    from udifftext_tpu_torch.scripts import flash_variants as variants_probe
    from udifftext_tpu_torch.scripts import glue_fusion_probe, resblock_probe, serve_bench
    from udifftext_tpu_torch.scripts._timing import bound_ms, card_line, nbytes
    from udifftext_tpu_torch.scripts.ocr_train_probe import ocr_train_graph
    from udifftext_tpu_torch.serving import InpaintService
    from udifftext_tpu_torch.train import to_device, train

    kernel_fns = kernel_wrappers()

    def expected(**launched) -> dict:
        """A path's launch counts: the named kernels, and 0 for every other."""
        return {**dict.fromkeys(counts(*kernel_fns), 0), **launched}

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. the card
    card = card_line(dev)
    log(card)
    log(f"[torch] {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. the build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {_build.library_path().name} in {time.perf_counter() - t0:.2f} s")
    kernel, mma_kernels, registers = "", set(), {}
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        m = re.search(r"entry function '\w*?((?:flash_fwd_mma|flash_bwd_dq_mma|flash_bwd_dkdv_mma"
                      r"|flash_fwd|flash_bwd_dq|flash_bwd_dkdv|geglu_mma|geglu_wmma"
                      r"|geglu_simt|geglu_reduce|ln_gemm_mma|ln_gemm|cross_attn_mma|cross_attn|gn_stats"
                      r"|gn_apply|gn_cluster|flash_variant_mma|flash_variant_fma)_kernel)(\w*)'",
                      line)
        if m:
            kernel = m.group(1) + m.group(2).replace("__nv_bfloat16", "bf16")
        elif "spill stores" in line or "registers" in line:
            log(f"[ptxas] {kernel}: {line.split(':', 1)[-1].strip()}")
            used = re.search(r"Used (\d+) registers", line)
            if used:
                registers[kernel] = int(used.group(1))
            if "_mma_" in kernel and "spill stores" in line:
                mma_kernels.add(kernel)
                if "0 bytes spill stores, 0 bytes spill loads" not in line:
                    fail(f"{kernel} spills registers: {line.strip()}")
        elif "wgmma" in line and "serialized" in line:
            fail(f"the compiler serialized a wgmma pipeline: {line.strip()}")
    def variant_kernel(dtype, bq, bk, transposed, clamp):
        """The mangled-name stem of the instantiation serving a variant."""
        route = kernel_route(dtype)
        return (f"flash_variant_{route}_kernelILi{bq}ELi{bk}ELb{int(transposed)}"
                f"ELb{int(clamp is not None)}EE")

    # three flash kernels, the GEGLU kernel's instantiations <NT, G, RG>, the
    # flash variants' <BQ, BK, TR, CLAMP> (v1 and v3 share theirs), the
    # t_attn branch's <RG> (64 and 128 rows a block) and LN→projection's
    # <N, RG> (160- or 64-column tiles, 64 or 128 rows a block)
    variant_stems = {variant_kernel(torch.bfloat16, bq, bk, tr, cl)
                     for bq, bk in TILE_MENU[torch.bfloat16] for tr, cl in VARIANTS.values()}
    cross_stems = {f"cross_attn_mma_kernelILi{rg}EE" for rg in (1, 2)}
    cross_stems |= {f"ln_gemm_mma_kernelILi{n_}ELi{rg}EE" for n_ in MMA_WIDTHS for rg in (1, 2)}
    n_mma = 3 + len(GEGLU_MMA_SHAPES) + len(variant_stems) + len(cross_stems)
    names = " ".join(mma_kernels)
    if len(mma_kernels) != n_mma or not all(
            f"geglu_mma_kernelILi{nt}ELi{g_}ELi{rg}EE" in names
            for nt, g_, rg in GEGLU_MMA_SHAPES) or not all(
                st in names for st in variant_stems | cross_stems):
        fail(f"the build log names {sorted(mma_kernels)}, not the {n_mma} tensor-core kernels")

    def registers_of(stem):
        return next((n for name, n in registers.items() if name.startswith(stem)), None)
    for dtype, pairs in TILE_MENU.items():
        for bq, bk in pairs:
            log(f"[smem] flash_variant {dtype} tiles ({bq}, {bk}): "
                f"{smem_bytes(bq, bk, False, dtype)} bytes of dynamic shared memory, "
                f"{smem_bytes(bq, bk, True, dtype)} transposed")

    # 3. kernels against their plain versions
    F = torch.nn.functional
    g = torch.Generator(dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    records = {}
    flash_cases = [  # (label, B, N, heads, d, dtype): ds1/ds2 self-attention
        ("ds1 B=2", 2, 4096, 5, 64, torch.bfloat16), ("ds1 B=20", 20, 4096, 5, 64, torch.bfloat16),
        ("ds2 B=2", 2, 1024, 10, 64, torch.bfloat16),
        ("ds2 B=20", 20, 1024, 10, 64, torch.bfloat16),
        ("ds1 B=32", 32, 4096, 5, 64, torch.bfloat16),  # the glue probe's shape
        ("ds2 B=2 fp32", 2, 1024, 10, 64, torch.float32),
        ("(1, 512, 2, 128) bf16", 1, 512, 2, 128, torch.bfloat16),
    ]
    for label, b, n, h, d, dtype in flash_cases:
        q, k, v = (randn(b, n, h, d, dtype=dtype) for _ in range(3))
        out, lse = flash_attention(q, k, v)
        route = flash_attention.last_route
        ref, ref_lse = flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        tol = bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5 * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v), reps=5)
        # the one PyTorch call for the same function, on (B, H, N, D) views of the same tensors
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
        flops = 4 * b * h * n * n * d
        note = record(records, "flash_attention", label, err, ms, plain_ms,
                      bound_ms(flops, nbytes(q, k, v, out, lse), dtype), lib_ms)
        records["flash_attention"].setdefault("kernel_route", route)
        log(f"[flash] {label}: route {route}; max_abs_err {err:.3e} (tol {tol:.3e}), lse err "
            f"{lse_err:.3e} (tol 1e-4); kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.3f} ms, {note}")
        if not (err <= tol and lse_err <= 1e-4):
            fail(f"flash {label} disagrees with its plain version")
        if route != flash_kernel_route(dtype, d) or (route == "mma") != (
                dtype == torch.bfloat16 and d == 64):
            fail(f"flash {label} was served by the {route} route")
        del q, k, v, out, ref, lse, ref_lse, qt, kt, vt

    def geglu_inputs(m, c, dtype):
        x = randn(m, c, dtype=dtype)
        w1, b1 = randn(8 * c, c, dtype=dtype, scale=c**-0.5), randn(8 * c, dtype=dtype, scale=0.1)
        w2 = randn(c, 4 * c, dtype=dtype, scale=(4 * c) ** -0.5)
        return x, w1, b1, w2, randn(c, dtype=dtype, scale=0.1)

    def products_ms(x, w1, w2):
        """The two cuBLAS products of the plain composition alone, on
        preallocated tensors of the working dtype, no gating in between."""
        hg = torch.empty((x.shape[0], w1.shape[0]), dtype=x.dtype, device=dev)
        act = hg[:, :w2.shape[1]]
        out = torch.empty_like(x)

        def run():
            torch.matmul(x, w1.t(), out=hg)
            torch.matmul(act, w2.t(), out=out)
        return time_ms(run)

    def composition_ms(x, w1, b1, w2, b2):
        """The plain composition `GEGLUFeedForward` runs under impl="plain":
        two products in the working dtype around an eager gate."""
        def run():
            h, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
            return F.linear(h * F.gelu(gate), w2, b2)
        return time_ms(run)

    def check_geglu_route(name, wrapper, label, dtype, c):
        want = geglu_kernel_route(dtype, c)
        if wrapper.last_route != want or (want == "mma") != (
                dtype == torch.bfloat16 and c % 64 == 0):
            fail(f"{name} {label} was served by the {wrapper.last_route} route, not {want}")
        plan = wrapper.last_plan
        return (f"route {want}, {plan.rows} rows a block, {plan.splits} split(s), "
                f"{plan.launches} launch(es), {plan.partial_bytes} partial bytes")

    geglu_cases = [  # (label, rows, C, dtype): ds1/ds2/ds4 feed-forwards
        ("ds1 B=2", 2 * 4096, 320, torch.bfloat16), ("ds2 B=2", 2 * 1024, 640, torch.bfloat16),
        ("ds4 B=2", 2 * 256, 1280, torch.bfloat16), ("ds1 B=20", 20 * 4096, 320, torch.bfloat16),
        ("ds2 B=20", 20 * 1024, 640, torch.bfloat16), ("ds4 B=20", 20 * 256, 1280, torch.bfloat16),
        ("ragged ds1", 2 * 4096 - 37, 320, torch.bfloat16),  # M not a multiple of the row tile
        ("ds2 B=2 fp32", 2 * 1024, 640, torch.float32),
    ]
    for label, m, c, dtype in geglu_cases:
        x, w1, b1, w2, b2 = geglu_inputs(m, c, dtype)
        out = geglu_ff(x, w1, b1, w2, b2)
        how = check_geglu_route("geglu", geglu_ff, label, dtype, c)
        ref = geglu_ff_ref(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = bf16_tol(ref) if dtype == torch.bfloat16 else 1e-5 * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: geglu_ff(x, w1, b1, w2, b2))
        queued_ms = back_to_back_ms(lambda: geglu_ff(x, w1, b1, w2, b2))
        plain_ms = time_ms(lambda: geglu_ff_ref(x, w1, b1, w2, b2), reps=5)
        gemm_ms, comp_ms = products_ms(x, w1, w2), composition_ms(x, w1, b1, w2, b2)
        flops = 2 * m * 3 * c * 4 * c
        note = record(records, "geglu_ff", label, err, ms, plain_ms,
                      bound_ms(flops, nbytes(x, w1, b1, w2, b2, out), dtype))
        records["geglu_ff"].setdefault("kernel_route", geglu_ff.last_route)
        log(f"[geglu] {label} (M={m}, C={c}): {how}; max_abs_err {err:.3e} (tol {tol:.3e}); "
            f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s; {queued_ms:.3f} ms each when 20 "
            f"are queued back to back), plain {plain_ms:.3f} ms, the module's plain composition {comp_ms:.3f} ms, its two cuBLAS products alone "
            f"{gemm_ms:.3f} ms, {note}")
        if not err <= tol:
            fail(f"geglu {label} disagrees with its plain version")
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
        route = flash_attention_bwd.last_route
        torch.cuda.synchronize()
        want = flash_attention_bwd_ref(q, k, v, out, lse, do)
        errs = [float((g_.float() - w_.float()).abs().max()) for g_, w_ in zip(got, want)]
        tols = [grad_tol(w_) for w_ in want]
        del got, want
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do))
        plain_ms = time_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do), reps=3)
        # 5 products of N×N×d (the TPU kernel's count; the two passes here do 7)
        flops = 10 * b * h * n * n * 64
        # the library's backward of the same function: autograd through torch's fused attention
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                     retain_graph=True), reps=5)
        moved = nbytes(q, k, v, out, do, lse) + nbytes(q, k, v)  # dq, dk, dv written
        note = record(records, "flash_attention_bwd", label, max(errs), ms, plain_ms,
                      bound_ms(flops, moved, dtype), lib_ms)
        records["flash_attention_bwd"].setdefault("kernel_route", route)
        log(f"[flash_bwd] {label}: route {route}; max_abs_err dq/dk/dv "
            f"{' / '.join(f'{e:.3e}' for e in errs)} (tol {' / '.join(f'{t:.3e}' for t in tols)}); "
            f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, {note}")
        if not all(e <= t for e, t in zip(errs, tols)):
            fail(f"flash backward {label} disagrees with its plain version")
        if route != ("mma" if dtype == torch.bfloat16 else "fma"):
            fail(f"flash backward {label} was served by the {route} route")
        del q, k, v, do, out, lse, qt, kt, vt, lib_out, dot
        torch.cuda.empty_cache()

    # 3c. the LayerNorm-fused kernels against their plain versions
    def tol_of(ref):
        return bf16_tol(ref) if ref.dtype == torch.bfloat16 else 1e-5 * max(
            1.0, float(ref.abs().max()))

    def max_err(got, ref):
        return float((got.float() - ref.float()).abs().max())

    def ln_params(c):
        return (1.0 + 0.1 * randn(c, dtype=torch.float32), 0.1 * randn(c, dtype=torch.float32))

    def check_grads(name, fn, ref_fn, ins, outs_like):
        """Gradients through the wrapper's autograd Function against the plain
        version's autograd, every input a leaf. Tolerance: four bf16 ulps of
        each gradient's largest entry when x is bf16 (the feed-forward's
        backward rounds its products to bf16 where the plain version's
        autograd keeps fp32; the fp32 LayerNorm parameters' gradients inherit
        that), 1e-4 of it in fp32."""
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        got = torch.autograd.grad(fn(*leaves), leaves, outs_like)
        want = torch.autograd.grad(ref_fn(*leaves), leaves, outs_like)
        torch.cuda.synchronize()
        errs = [max_err(g_, w_) for g_, w_ in zip(got, want)]
        rel = 2**-6 if ins[0].dtype == torch.bfloat16 else 1e-4
        tols = [rel * float(w_.float().abs().max()) for w_ in want]
        log(f"[{name}] gradients of {len(leaves)} inputs through the autograd Function vs the "
            f"plain version's autograd: worst error/tolerance "
            f"{max(e / t for e, t in zip(errs, tols)):.3f}")
        if not all(e <= t and g_.dtype == w_.dtype for e, t, g_, w_ in zip(errs, tols, got, want)):
            fail(f"{name} gradients disagree with the plain version's autograd")

    def t_attn_composition(x, ln_s, ln_b, wq, k, v, wo, bo, heads):
        """The unfused t_attn branch the block runs with fuse_glue="off":
        LayerNormF32, to_q, the plain attention of `CrossAttention`, to_out
        with its bias, the residual."""
        b, n, c = x.shape
        xn = F.layer_norm(x.float(), (c,), ln_s, ln_b, 1e-5).to(x.dtype)
        q = F.linear(xn, wq).reshape(b, n, heads, 64)
        sim = (torch.einsum("bnhd,blhd->bhnl", q, k) * 64**-0.5).float()
        o = torch.einsum("bhnl,blhd->bnhd", torch.softmax(sim, dim=-1).to(x.dtype), v)
        return F.linear(o.reshape(b, n, heads * 64), wo, bo) + x

    def cross_products_ms(x, wq, wo):
        """The composition's two cuBLAS products alone (to_q, to_out), on
        preallocated tensors of the working dtype."""
        x2 = x.reshape(-1, x.shape[-1])
        q = torch.empty((x2.shape[0], wq.shape[0]), dtype=x.dtype, device=dev)
        o = torch.empty_like(x2)

        def run():
            torch.matmul(x2, wq.t(), out=q)
            torch.matmul(q, wo.t(), out=o)
        return time_ms(run)

    def check_cross_attention(label, x, ln_s, ln_b, wq, wo, l, k_scale=1.0, timed=True):
        """fused_cross_attention against its plain version on hoisted k, v of
        L tokens (k scaled by `k_scale`), its route named; timed beside the
        unfused composition and that composition's two products. Returns the
        inputs."""
        (b, n, c), dtype = x.shape, x.dtype
        heads = wq.shape[0] // 64
        k_, v_ = randn(b, l, heads, 64, dtype=dtype, scale=k_scale), randn(b, l, heads, 64, dtype=dtype)
        bo = randn(c, dtype=dtype, scale=0.1)
        ca_in = (x, ln_s, ln_b, wq, k_, v_, wo, bo)
        out = fused_cross_attention(*ca_in, heads)
        plan = fused_cross_attention.last_plan
        ref = fused_cross_attention_ref(*ca_in, heads)
        torch.cuda.synchronize()
        err, tol = max_err(out, ref), tol_of(ref)
        want = cross_attention_plan(dtype, b, n, c, heads * 64)
        line = (f"[cross_attention] {label} (L={l}, {heads} heads): route {plan.route}, "
                f"{plan.rows} rows a block; max_abs_err {err:.3e} (tol {tol:.3e})")
        if timed:
            ms = time_ms(lambda: fused_cross_attention(*ca_in, heads))
            queued_ms = back_to_back_ms(lambda: fused_cross_attention(*ca_in, heads))
            plain_ms = time_ms(lambda: fused_cross_attention_ref(*ca_in, heads), reps=5)
            comp_ms = time_ms(lambda: t_attn_composition(*ca_in, heads))
            gemm_ms = cross_products_ms(x, wq, wo)
            flops = 2 * b * n * c * (2 * c + 2 * l)
            note = record(records, "fused_cross_attention", label, err, ms, plain_ms,
                          bound_ms(flops, nbytes(*ca_in, out), dtype))
            records["fused_cross_attention"].setdefault("kernel_route", plan.route)
            line += (f"; kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s; {queued_ms:.3f} ms "
                     f"each when 20 are queued back to back), plain {plain_ms:.3f} ms, the "
                     f"unfused composition {comp_ms:.3f} ms, its two cuBLAS products alone "
                     f"{gemm_ms:.3f} ms, {note}")
        log(line)
        if not err <= tol:
            fail(f"fused_cross_attention {label} disagrees with its plain version")
        if plan != want or (plan.route == "mma") != (dtype == torch.bfloat16 and c in (320, 640)):
            fail(f"fused_cross_attention {label} was served by {plan}, not {want}")
        return ca_in

    def ln_products_ms(x, ln_s, ln_b, ws):
        """The unfused composition's cuBLAS products alone, on its normalized
        rows and preallocated outputs of the working dtype."""
        c = x.shape[-1]
        xn = F.layer_norm(x.float(), (c,), ln_s, ln_b, 1e-5).to(x.dtype).reshape(-1, c)
        outs = [torch.empty((xn.shape[0], w.shape[0]), dtype=x.dtype, device=dev) for w in ws]

        def run():
            for w, o in zip(ws, outs):
                torch.matmul(xn, w.t(), out=o)
        return time_ms(run)

    def check_ln_gemm(label, x, ln_s, ln_b, ws, min_wraps=0):
        """ln_gemm (one weight, one wide output) or ln_gemm3 (three weights,
        three compact outputs) against its plain version, with its route and
        plan named and checked against `ln_gemm_plan` ("mma" for bf16 at
        C = 320, 640, 1280; "fma" for fp32); timed single and back to back
        beside the unfused composition the block runs with fuse_glue="off"
        (LayerNormF32, then F.linear: one wide or three separate) and that
        composition's cuBLAS products alone. `min_wraps`: the times the
        busiest block's ring must wrap."""
        wide = len(ws) == 1
        name, fn, ref_fn = (("ln_gemm", ln_gemm, ln_gemm_ref) if wide
                            else ("ln_gemm3", ln_gemm3, ln_gemm3_ref))
        dtype, c, f = x.dtype, x.shape[-1], ws[0].shape[0]
        m = x.numel() // c
        outs, refs = fn(x, ln_s, ln_b, *ws), ref_fn(x, ln_s, ln_b, *ws)
        outs, refs = ((outs,), (refs,)) if wide else (outs, refs)
        plan = fn.last_plan
        torch.cuda.synchronize()
        err = max(max_err(o_, r_) for o_, r_ in zip(outs, refs))
        tol = min(tol_of(r_) for r_ in refs)
        ms = time_ms(lambda: fn(x, ln_s, ln_b, *ws))
        queued_ms = back_to_back_ms(lambda: fn(x, ln_s, ln_b, *ws))
        plain_ms = time_ms(lambda: ref_fn(x, ln_s, ln_b, *ws), reps=5)

        def composition():
            xn = F.layer_norm(x.float(), (c,), ln_s, ln_b, 1e-5).to(dtype)
            return [F.linear(xn, w) for w in ws]
        comp_ms, gemm_ms = time_ms(composition), ln_products_ms(x, ln_s, ln_b, ws)
        flops = 2 * m * c * len(ws) * f
        note = record(records, name, label, err, ms, plain_ms,
                      bound_ms(flops, nbytes(x, ln_s, ln_b, *ws, *outs), dtype))
        records[name].setdefault("kernel_route", plan.route)
        wraps = plan.steps / plan.stages if plan.stages else 0.0
        how = f"route {plan.route}, {plan.rows} rows a block"
        if plan.route == "mma":
            spans = {len({wi for wi, _, _ in ln_gemm_block_columns(plan, f, blk)})
                     for blk in range(plan.groups)}
            how += (f", {plan.n}-column tiles, {plan.group_tiles} of {plan.tiles} a block "
                    f"({plan.groups} column groups, {max(spans)} weight(s) in the widest), "
                    f"{plan.blocks} blocks, a {plan.stages}-stage ring wrapped {wraps:.1f} times "
                    f"by the busiest block, {plan.smem_bytes} bytes of shared memory")
        log(f"[{name}] {label} ({'' if wide else '3x '}{c}->{f}): {how}; max_abs_err {err:.3e} "
            f"(tol {tol:.3e}); kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s; "
            f"{queued_ms:.4f} ms each when 20 are queued back to back), plain {plain_ms:.3f} ms, "
            f"the unfused composition {comp_ms:.3f} ms, its cuBLAS products alone "
            f"{gemm_ms:.3f} ms, {note}")
        if not (err <= tol and all(o_.is_contiguous() for o_ in outs)):
            fail(f"{name} {label} disagrees with its plain version")
        want = ln_gemm_plan(dtype, m, c, f, len(ws))
        want_route = "fma" if dtype == torch.float32 else "mma" if c in (320, 640, 1280) else None
        if plan != want or (want_route is not None and plan.route != want_route):
            fail(f"{name} {label} was served by {plan}, not {want} on route {want_route}")
        if wraps < min_wraps:
            fail(f"{name} {label}: the ring wrapped {wraps} times, not {min_wraps}")
        del outs, refs

    glue_cases = [  # (label, B, N, C, dtype); the probe's shapes first
        ("ds1 B=32", 32, 4096, 320, torch.bfloat16), ("ds2 B=32", 32, 1024, 640, torch.bfloat16),
        ("ds1 B=2", 2, 4096, 320, torch.bfloat16), ("ds2 B=2", 2, 1024, 640, torch.bfloat16),
        ("ds2 B=2 fp32", 2, 1024, 640, torch.float32),
        ("(2, 128, 1280)", 2, 128, 1280, torch.bfloat16),
    ]
    for label, b, n, c, dtype in glue_cases:
        heads, m = c // 64, b * n
        x = randn(b, n, c, dtype=dtype)
        ln_s, ln_b = ln_params(c)
        ws = [randn(c, c, dtype=dtype, scale=c**-0.5) for _ in range(3)]
        w3 = torch.cat(ws, dim=0)

        check_ln_gemm(label, x, ln_s, ln_b, [w3])
        if c == 1280:  # the single-output kernel's own test shape; the block has no ds4 path
            continue
        check_ln_gemm(label, x, ln_s, ln_b, ws)

        ca_in = check_cross_attention(label, x, ln_s, ln_b, ws[0], ws[1], 12)

        w1, b1 = randn(8 * c, c, dtype=dtype, scale=c**-0.5), randn(8 * c, dtype=dtype, scale=0.1)
        w2 = randn(c, 4 * c, dtype=dtype, scale=(4 * c) ** -0.5)
        b2 = randn(c, dtype=dtype, scale=0.1)
        ff_in = (x, ln_s, ln_b, w1, b1, w2, b2)
        out = geglu_ff_ln(*ff_in)
        how = check_geglu_route("geglu_ff_ln", geglu_ff_ln, label, dtype, c)
        ref = geglu_ff_ln_ref(*ff_in)
        torch.cuda.synchronize()
        err, tol = max_err(out, ref), tol_of(ref)
        ms = time_ms(lambda: geglu_ff_ln(*ff_in))
        queued_ms = back_to_back_ms(lambda: geglu_ff_ln(*ff_in))
        plain_ms = time_ms(lambda: geglu_ff_ln_ref(*ff_in), reps=3)
        gemm_ms = products_ms(x.reshape(m, c), w1, w2)
        flops = 2 * m * 3 * c * 4 * c
        note = record(records, "geglu_ff_ln", label, err, ms, plain_ms,
                      bound_ms(flops, nbytes(*ff_in, out), dtype))
        records["geglu_ff_ln"].setdefault("kernel_route", geglu_ff_ln.last_route)
        log(f"[geglu_ln] {label} (M={m}, C={c}): {how}; max_abs_err {err:.3e} (tol {tol:.3e}); "
            f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s; {queued_ms:.3f} ms each when 20 "
            f"are queued back to back), plain {plain_ms:.3f} ms, its two cuBLAS products alone "
            f"{gemm_ms:.3f} ms, {note}")
        if not err <= tol:
            fail(f"geglu_ff_ln {label} disagrees with its plain version")
        del out, ref

        if label == "ds2 B=2":  # gradients at one shape
            g1, g3 = randn(b, n, c), randn(b, n, 3 * c)
            check_grads("ln_gemm", ln_gemm, ln_gemm_ref, (x, ln_s, ln_b, w3), g3)
            check_grads("ln_gemm3", ln_gemm3, ln_gemm3_ref, (x, ln_s, ln_b, *ws), [g1, g1, g1])
            check_grads("cross_attention", lambda *a: fused_cross_attention(*a, heads),
                        lambda *a: fused_cross_attention_ref(*a, heads), ca_in, g1)
            check_grads("geglu_ln", geglu_ff_ln, geglu_ff_ln_ref, ff_in, g1)
            del g1, g3
        del x, ws, w3, ca_in, w1, b1, w2, b2, ff_in
        torch.cuda.empty_cache()

    # ln_gemm's edges: weights of F = 336 rows (ragged last 64-column tiles,
    # column groups across the q/k boundary), and a ring wrapped >= 10 times
    for label, b, n, c, f, n_w, wraps in (("ragged F=336", 2, 4096, 320, 336, 3, 0),
                                          ("ring C=1280", 2, 1024, 1280, 1280, 1, 10)):
        x = randn(b, n, c)
        ln_s, ln_b = ln_params(c)
        check_ln_gemm(label, x, ln_s, ln_b, [randn(f, c, scale=c**-0.5) for _ in range(n_w)],
                      min_wraps=wraps)
        del x
    torch.cuda.empty_cache()

    # the t_attn kernel's edges: a full 64-token context, and logits large
    # enough (|s| past 88, where exp overflows fp32) that the softmax rests
    # on its max subtraction
    for label, b, n, c, l, k_scale in (("ds1 B=2 L=64", 2, 4096, 320, 64, 1.0),
                                       ("ds2 B=2 max binding", 2, 1024, 640, 12, 40.0)):
        x = randn(b, n, c)
        ln_s, ln_b = ln_params(c)
        wq, wo = (randn(c, c, scale=c**-0.5) for _ in range(2))
        ca_in = check_cross_attention(label, x, ln_s, ln_b, wq, wo, l, k_scale, timed=False)
        if k_scale > 1:
            xn = F.layer_norm(x.float(), (c,), ln_s, ln_b, 1e-5).to(x.dtype)
            q = F.linear(xn, wq).float().reshape(b, n, c // 64, 64)
            top = float(torch.einsum("bnhd,blhd->bhnl", q, ca_in[4].float()).abs().max()) / 8
            log(f"[cross_attention] {label}: largest |logit| {top:.1f}")
            if not top > 88:
                fail("the max-binding case does not drive the logits past exp's fp32 range")
        del x, ca_in
    torch.cuda.empty_cache()

    # 3d. the probe-level kernels: fused GroupNorm+SiLU and the flash variants
    def device_launches(fn, calls: int = 4) -> float:
        """Kernels one call of `fn` puts on the device: torch.profiler's count
        over `calls` calls, divided by `calls`. The profiler can drop device
        activity at the edges of its window (a two-kernel call once counted
        one), so the calls sit between two marker kernels and pauses."""
        from torch.profiler import ProfilerActivity, profile

        marker = torch.zeros(1, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for step in range(calls + 2):
                if step in (0, calls + 1):
                    time.sleep(0.02)
                    marker.add_(1)
                else:
                    fn()
                torch.cuda.synchronize()
            time.sleep(0.02)
        names = ("gn_cluster_kernel", "gn_stats_kernel", "gn_apply_kernel")
        return sum(ev.count for ev in prof.key_averages()
                   if any(k in ev.key for k in names)) / calls

    gn_cases = [  # (label, shape, dtype, with_silu, eps, common offset); the probe's shape first
        ("ds1 B=32", (32, 64, 64, 320), torch.bfloat16, True, 1e-5, 0.0),
        ("ds1 B=2", (2, 64, 64, 320), torch.bfloat16, True, 1e-5, 0.0),
        ("ds2 B=2", (2, 32, 32, 640), torch.bfloat16, True, 1e-5, 0.0),
        ("ds4 B=2", (2, 16, 16, 1280), torch.bfloat16, True, 1e-5, 0.0),
        ("ds1 decoder B=2", (2, 64, 64, 960), torch.bfloat16, True, 1e-5, 0.0),
        ("ds2 B=2 fp32", (2, 32, 32, 640), torch.float32, True, 1e-5, 0.0),
        ("(2, 1000, 64) fp32, no SiLU, eps 1e-6", (2, 1000, 64), torch.float32, False, 1e-6, 0.0),
        ("ds1 B=2 fp32, offset 1000", (2, 64, 64, 320), torch.float32, True, 1e-5, 1000.0),
        # N = 4133 rows: the last CTA of a cluster holds fewer than the others
        ("ragged N=4133 B=2", (2, 4133, 320), torch.bfloat16, True, 1e-5, 0.0),
        # the VAE decoder's last GroupNorm: 4 MB a (sample, group), more than 8 CTAs hold
        ("VAE decoder (1, 512, 512, 128) fp32", (1, 512, 512, 128), torch.float32, True, 1e-5, 0.0),
    ]
    for label, shape, dtype, with_silu, eps, offset in gn_cases:
        c = shape[-1]
        x = (torch.randn(*shape, generator=g, device=dev) + offset).to(dtype)
        gn_s, gn_b = ln_params(c)
        out = fused_groupnorm_silu(x, gn_s, gn_b, 32, eps, with_silu)
        plan = fused_groupnorm_silu.last_plan
        ref = fused_groupnorm_silu_ref(x, gn_s, gn_b, 32, eps, with_silu)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        # under the offset both sides subtract fp32 means of values whose own
        # spacing is 6e-5 and that were summed in another order
        tol = 1e-3 if offset else tol_of(ref)
        ms = time_ms(lambda: fused_groupnorm_silu(x, gn_s, gn_b, 32, eps, with_silu))
        queued_ms = back_to_back_ms(lambda: fused_groupnorm_silu(x, gn_s, gn_b, 32, eps, with_silu))
        plain_ms = time_ms(lambda: fused_groupnorm_silu_ref(x, gn_s, gn_b, 32, eps, with_silu),
                           reps=5)
        # the library's call for the same function, on the channels-first view of the same tensor
        xv = x.movedim(-1, 1)
        w_, b_ = gn_s.to(dtype), gn_b.to(dtype)
        lib_ms = time_ms(lambda: F.silu(F.group_norm(xv, 32, w_, b_, eps)) if with_silu
                         else F.group_norm(xv, 32, w_, b_, eps))
        # the same call without the layout copy it makes of that view: on an
        # NCHW-contiguous copy made outside the timer (logged, not recorded)
        xc = xv.contiguous()
        lib_nchw_ms = time_ms(lambda: F.silu(F.group_norm(xc, 32, w_, b_, eps)) if with_silu
                              else F.group_norm(xc, 32, w_, b_, eps))
        lib_queued_ms = back_to_back_ms(lambda: F.silu(F.group_norm(xc, 32, w_, b_, eps))
                                        if with_silu else F.group_norm(xc, 32, w_, b_, eps))
        note = record(records, "fused_groupnorm_silu", label, err, ms, plain_ms,
                      bound_ms(10 * x.numel(), nbytes(x, gn_s, gn_b, out), dtype), lib_ms)
        records["fused_groupnorm_silu"].setdefault("kernel_route", plan.route)
        how = (f"route {plan.route}, {plan.slice_groups} groups a slice, {plan.cluster} CTAs a "
               f"cluster, {plan.rows} rows a CTA, {plan.smem_bytes} bytes of shared memory"
               if plan.route == "cluster" else f"route {plan.route}, {plan.rows} rows a chunk")
        if label in ("ds1 B=32", gn_cases[-1][0]):
            launched = device_launches(lambda: fused_groupnorm_silu(x, gn_s, gn_b, 32, eps,
                                                                    with_silu))
            how += f"; {launched:g} device launch(es) a call (torch.profiler, 4 calls)"
            if launched != plan.launches:
                fail(f"fused_groupnorm_silu {label}: {launched:g} device launches a call, "
                     f"the plan says {plan.launches}")
        log(f"[groupnorm] {label} {shape}: {how}; max_abs_err {err:.3e} (tol {tol:.3e}); kernel "
            f"{ms:.3f} ms ({nbytes(x, out) / ms / 1e6:.0f} GB/s; {queued_ms:.4f} ms each when 20 "
            f"are queued back to back), plain {plain_ms:.3f} ms, {note}; library on an NCHW copy "
            f"{lib_nchw_ms:.3f} ms ({lib_queued_ms:.4f} ms queued)")
        if not err <= tol:
            fail(f"fused_groupnorm_silu {label} disagrees with its plain version")
        want_route = "two_pass" if label == gn_cases[-1][0] else "cluster"
        if plan.route != want_route or plan != groupnorm_plan(
                dtype, shape[0], x.numel() // (shape[0] * c), c, 32,
                torch.cuda.get_device_properties(dev).multi_processor_count):
            fail(f"fused_groupnorm_silu {label} was served by {plan}, not route {want_route}")
        del x, out, ref, xv, xc
    torch.cuda.empty_cache()

    clamps = sorted({c for _, c in VARIANTS.values()}, key=lambda c: c or 0.0)

    def check_variants(label, q, k, v, timed):
        """Every variant at every tile pair of q's dtype against the plain
        version of its own function (softmax, or the form clamped at ±75 or
        ±60), and v1's log Σp against the plain version's."""
        dtype, (bh, n, _) = q.dtype, q.shape
        refs = {clamp: flash_variant_ref(q, k, v, clamp) for clamp in clamps}
        flops = 4 * bh * n * n * 64
        if timed:
            plain = {clamp: time_ms(lambda: flash_variant_ref(q, k, v, clamp), reps=3)
                     for clamp in clamps}
            # (1, B·H, N, d): on three dimensions the call would not reach its fused kernels
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]))
        for name, (transposed, clamp) in VARIANTS.items():
            ref = refs[clamp][0]
            tol = tol_of(ref)
            for bq, bk in TILE_MENU[dtype]:
                out = flash_variant(q, k, v, name, bq, bk)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                route = kernel_route(dtype)
                regs = registers_of(variant_kernel(dtype, bq, bk, transposed, clamp))
                line = (f"[variants] {label} {name} ({bq}, {bk}): route {route}, {regs} registers; "
                        f"max_abs_err {err:.3e} (tol {tol:.3e})")
                if timed:
                    ms = time_ms(lambda: flash_variant(q, k, v, name, bq, bk), reps=5)
                    note = record(records, f"flash_variant_{name}", f"{label} tiles ({bq}, {bk})",
                                  err, ms, plain[clamp],
                                  bound_ms(flops, nbytes(q, k, v, out), dtype), lib_ms)
                    records[f"flash_variant_{name}"].setdefault("kernel_route", route)
                    line += (f"; kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                             f"{plain[clamp]:.3f} ms, {note}")
                log(line)
                if not err <= tol:
                    fail(f"flash variant {name} ({bq}, {bk}) {label} disagrees with its plain version")
                if regs is None:
                    fail(f"the build log has no register count for flash variant {name} "
                         f"({bq}, {bk}) in {dtype}")
            if name == "v1":  # log Σp, the log of `_flash_kernel`'s denominator
                for bq, bk in TILE_MENU[dtype]:
                    _, lse = flash_v1_with_lse(q, k, v, bq, bk)
                    torch.cuda.synchronize()
                    lse_err = float((lse - refs[CLAMP_V1][1]).abs().max())
                    log(f"[variants] {label} v1 ({bq}, {bk}) log Σp err {lse_err:.3e} (tol 1e-4)")
                    if not lse_err <= 1e-4:
                        fail(f"flash variant v1 ({bq}, {bk}) {label}: log Σp disagrees")
        return refs

    for label, bh, n, dtype in (("B·H=160 N=4096", 160, 4096, torch.bfloat16),
                                ("B·H=10 N=4096", 10, 4096, torch.bfloat16),
                                ("B·H=160 N=1024", 160, 1024, torch.bfloat16),
                                ("B·H=10 N=1024", 10, 1024, torch.bfloat16),
                                ("B·H=10 N=1024 fp32", 10, 1024, torch.float32)):
        q, k, v = (randn(bh, n, 64, dtype=dtype, scale=0.3) for _ in range(3))
        check_variants(label, q, k, v, timed=True)
        del q, k, v
        torch.cuda.empty_cache()
    # logits past 80: v1 follows the form clamped at ±75, v3/v4 the one at
    # ±60, v2 the softmax
    q, k, v = (randn(10, 1024, 64, scale=sc) for sc in (9.0, 2.4, 0.3))
    logit_max = float((q[:1].float() @ k[:1].float().transpose(1, 2)).abs().max()) / 8
    refs = check_variants("clamp active", q, k, v, timed=False)
    apart = {c: max_err(refs[c][0], refs[None][0]) for c in (CLAMP_V1, CLAMP_EXP)}
    log(f"[variants] clamp active: largest |logit| {logit_max:.1f}; the forms clamped at ±75 "
        f"and ±60 are {apart[CLAMP_V1]:.3e} and {apart[CLAMP_EXP]:.3e} from softmax there")
    if not (logit_max > 80 and min(apart.values()) > 0.1):
        fail("the clamp-active case does not drive the logits past both clamps")
    for name, fn in (("fused_groupnorm_silu",
                      lambda t: fused_groupnorm_silu(t, *ln_params(64))),
                     ("flash_variant", lambda t: flash_variant(t, t, t, "v3"))):
        try:
            fn(torch.zeros(2, 64, 64, device=dev, requires_grad=True))
        except RuntimeError as e:
            log(f"[forward-only] {name} raises under grad: {str(e)[:60]}...")
        else:
            fail(f"{name} returned a tensor when a gradient was asked through it")
    del q, k, v, refs
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
    for run in range(4):  # the first builds caches; the spread of the rest is the host's
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
        want = expected(flash_attention=evals * 10, geglu_ff=evals * 15)
        if launches != want:
            fail(f"kernel launches {launches}, expected {want} (ds1+ds2 self-attention; "
                 "ds1/ds2/ds4 feed-forwards; no backward when sampling)")
    by_path["demo"] = launches
    demo_s = statistics.median(seconds[1:])
    log(f"[demo] output mean {float(images.mean()):.4f} std {float(images.std()):.4f}; s per "
        f"sample after the first run: median {statistics.median(seconds[1:]):.3f}, "
        f"min {min(seconds[1:]):.3f}, max {max(seconds[1:]):.3f}")
    profile_groups("demo, one sample",
                   lambda: predictor(batch, torch.Generator(dev).manual_seed(9)),
                   statistics.median(seconds[1:]))

    # 5c. a checkpoint round trip at full width: the seeded engine saved under
    # the reference prefixes (.ckpt) and its VAE alone (.safetensors), both
    # loaded into a freshly built engine as a run checkpoint and as the
    # graph's VAE file
    with tempfile.TemporaryDirectory(prefix="udt_ckpt_") as ckpt_dir:
        src = bundle.engine
        t0 = time.perf_counter()
        ckpt_path, vae_path = f"{ckpt_dir}/udifftext.ckpt", f"{ckpt_dir}/vae.safetensors"
        torch.save({"state_dict": {prefix + k: v.detach().cpu() for name, prefix in CKPT_PREFIXES
                                   for k, v in getattr(src, name).state_dict().items()}},
                   ckpt_path)
        write_safetensors(vae_path, src.vae.state_dict())
        save_s = time.perf_counter() - t0
        graph = copy.deepcopy(TEXTDESIGN_SD_2)
        graph["first_stage_config"]["params"]["ckpt_path"] = vae_path
        fresh = build_engine(graph, torch.bfloat16, dev)
        zero = {k: v for k, v in fresh.engine.unet.state_dict().items() if ZERO_INIT.search(k)}
        if len(zero) != ZERO_INIT_KEYS or any(bool(v.any()) for v in zero.values()):
            fail(f"a fresh engine has {len(zero)} zero-initialized UNet parameters (expected "
                 f"{ZERO_INIT_KEYS}), or one of them is not zero")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = {f"{k} (.safetensors)": r for k, r in loading.load_component_ckpts(fresh).items()}
        torch.cuda.synchronize()
        vae_s = time.perf_counter() - t0
        vae_equal = all(torch.equal(a, b_) for a, b_ in zip(fresh.engine.vae.state_dict().values(),
                                                            src.vae.state_dict().values()))
        t0 = time.perf_counter()
        reports.update(loading.load_from_torch_ckpt(fresh.engine, ckpt_path))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        sizes = {os.path.basename(p_): os.path.getsize(p_) / 2**30 for p_ in (ckpt_path, vae_path)}
    want_reports = {"vae (.safetensors)", "unet", "vae", "label_encoder"}
    counted = {k: tuple(len(x_) for x_ in r) for k, r in reports.items()}
    unequal = [f"{name}.{k}" for name, _ in CKPT_PREFIXES
               for (k, a), b_ in zip(getattr(fresh.engine, name).state_dict().items(),
                                     getattr(src, name).state_dict().values())
               if a.dtype != b_.dtype or not torch.equal(a, b_)]
    log(f"[ckpt] full-width round trip: {', '.join(f'{k} {v:.3f} GiB' for k, v in sizes.items())}; "
        f"saved in {save_s:.2f} s, the VAE file loaded in {vae_s:.2f} s, the .ckpt in "
        f"{load_s:.2f} s; (missing, unexpected, mismatched) keys {counted}; "
        f"{ZERO_INIT_KEYS} zero-initialized UNet parameters zero before the load; "
        f"{len(unequal)} parameters differ; peak host RSS {peak_rss_gib():.2f} GiB")
    if set(reports) != want_reports or any(c != (0, 0, 0) for c in counted.values()):
        fail(f"checkpoint round trip: reports {counted}, expected no missing, unexpected or "
             f"mismatched key in {sorted(want_reports)}")
    if not vae_equal or unequal:
        fail(f"checkpoint round trip: the VAE file's load equal {vae_equal}; parameters that "
             f"differ after the .ckpt load: {unequal[:5]}")
    del fresh, src, zero
    torch.cuda.empty_cache()

    # 5b. the implementation switch: the same engine built with attn_impl="plain"
    # (same seed, so the same weights) against the "auto" one, at the demo's shapes
    plain_bundle = build_engine(TEXTDESIGN_SD_2, torch.bfloat16, dev, attn_impl="plain")
    randomize_parameters(plain_bundle.engine, 0)
    x_ab = randn(2, 64, 64, 9)
    t_ab = torch.tensor([0.3, 0.3], device=dev)
    ctx_ab = randn(2, 12, 2048)
    eval_counts, eval_outs = {}, {}
    with torch.no_grad():
        for name, eng in (("auto", bundle.engine), ("plain", plain_bundle.engine)):
            reset(*kernel_fns)
            eval_outs[name] = eng.unet(x_ab, t_ab, ctx_ab, None)[0]
            torch.cuda.synchronize()
            eval_counts[name] = counts(*kernel_fns)
    ab_err = rel_l2(eval_outs["auto"], eval_outs["plain"])
    # both sides compute in bf16: 16 transformer blocks whose attention and
    # feed-forward round at other places (fp32 scores and hidden in the
    # kernels, bf16 products in the plain path); phase 4 holds ONE block to
    # 2e-2 against fp32, and the errors of a stack add up
    ab_tol = 5e-2
    log(f"[plain_ab] one UNet eval (B=2, bf16): launches auto {eval_counts['auto']}, plain "
        f"{eval_counts['plain']}; relative L2 auto vs plain {ab_err:.3e} (tol {ab_tol:.0e}); "
        f"GEGLU route {geglu_ff.last_route}")
    if eval_counts["auto"] != expected(flash_attention=10, geglu_ff=15):
        fail(f"a UNet eval under attn_impl='auto' launched {eval_counts['auto']}")
    if eval_counts["plain"] != expected():
        fail(f"a UNet eval under attn_impl='plain' launched {eval_counts['plain']}")
    if not (ab_err <= ab_tol and torch.isfinite(eval_outs["plain"]).all()):
        fail("the UNet under attn_impl='plain' disagrees with attn_impl='auto'")
    if geglu_ff.last_route != "mma":
        fail(f"the UNet's bf16 feed-forwards ran on the {geglu_ff.last_route} route")
    # ... and a 5-step sample under each, and under "auto" with only the
    # feed-forwards forced to their plain composition ("ff_plain": what the
    # GEGLU kernel alone is worth end to end)
    ffs = [m_ for m_ in bundle.engine.unet.modules() if isinstance(m_, GEGLUFeedForward)]
    ab_s = {"auto": [], "ff_plain": [], "plain": []}
    ab_want = {"auto": expected(flash_attention=70, geglu_ff=105),
               "ff_plain": expected(flash_attention=70), "plain": expected()}
    for name in ("plain", "ff_plain", "auto") + ("plain", "auto", "ff_plain", "ff_plain", "auto",
                                                 "plain"):  # the first three warm up
        eng = plain_bundle.engine if name == "plain" else bundle.engine
        for ff in ffs:
            ff.impl = "plain" if name == "ff_plain" else "auto"
        short = Predictor(eng, num_steps=5, cfg_scale=4.0, noise_iters=10,
                          noise_search_batched=True)
        reset(*kernel_fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images_ab, _ = short(batch, torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        ab_s[name].append(time.perf_counter() - t0)
        got = counts(*kernel_fns)
        if got != ab_want[name] or not torch.isfinite(images_ab).all():
            fail(f"a 5-step sample under {name!r} launched {got}, expected {ab_want[name]}")
    for ff in ffs:
        ff.impl = "auto"
    best = {k: min(v[1:]) for k, v in ab_s.items()}
    log(f"[plain_ab] 5-step sample (10 candidates, CFG 4.0; 7 UNet evals): kernels "
        f"{best['auto']:.3f} s, plain {best['plain']:.3f} s, flash kernels with plain "
        f"feed-forwards {best['ff_plain']:.3f} s (the faster of two runs each after a warm-up; "
        f"all runs: " + ", ".join(f"{k} {[round(t, 3) for t in v]}" for k, v in ab_s.items())
        + "); zero kernel launches under 'plain'")
    del eval_outs, x_ab, ctx_ab, images_ab, eng, short, ffs
    torch.cuda.empty_cache()

    # 14. the sampling options: encoder propagation, its quality gate and the
    # other samplers, on phase 5's engine and batch
    sampling_options(bundle.engine, plain_bundle.engine, batch, kernel_fns, expected, by_path,
                     ab_tol)
    del plain_bundle
    torch.cuda.empty_cache()

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
    if not (n_aae >= 50 and launches == expected(flash_attention=evals * 10,
                                                 flash_attention_bwd=n_aae * 10,
                                                 geglu_ff=evals * 15)):
        fail(f"AAE launches {launches}: expected ≥ 50 gradient evaluations, each with 10 "
             "flash forwards and backwards and 15 GEGLU forwards, besides the 52 sampling evals")
    short = Predictor(bundle.engine, num_steps=5, cfg_scale=4.0, noise_iters=10,
                      aae_enabled=True, detailed=True, noise_search_batched=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short(batch, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    profile_groups("AAE demo cut to 5 steps",
                   lambda: short(batch, torch.Generator(dev).manual_seed(0)),
                   time.perf_counter() - t0)
    del bundle, predictor, short, images, aux, maps
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
    want = expected(flash_attention=micro * 10, flash_attention_bwd=micro * 9,
                    geglu_ff=micro * 15)
    if launches != want:
        fail(f"training launches {launches}, predicted {want}")
    with tempfile.TemporaryDirectory(prefix="udt_train_") as log_dir:
        one = {"batch_size": micro_b, "base_learning_rate": 5e-5, "log_dir": log_dir,
               "lightning": {"accumulate_grad_batches": accum, "max_epochs": 1}}
        profile_groups(f"one optimizer step ({accum}×{micro_b})",
                       lambda: train(one, batches, bundle, seed=1, log_every=1), step_s[-1])
    mb = to_device(batches.batches[0], dev)
    eps = torch.zeros(micro_b, 64, 64, 4, device=dev)
    with torch.no_grad():
        enc_ms = time_ms(lambda: (engine.encode_first_stage(mb["image"], eps),
                                  engine.conditioner.encode_masked(mb["masked"], eps)), reps=3)
    log(f"[train] the two fp32 VAE encodes of a micro-batch of {micro_b}: {enc_ms:.1f} ms, "
        f"{accum * enc_ms / 1e3 / step_s[-1]:.3f} of a step")
    del engine, bundle, state, frozen, trained, batches, mb

    # 6b. the OCR path. (a) PARSeq-base with seeded random weights, fp32, on
    # the card against the same module on the CPU
    pq_cpu = randomize_parameters(PARSeq(), 0).eval()
    pq_gpu = copy.deepcopy(pq_cpu).to(dev)
    read_gpu, read_cpu = ParseqPredictor(pq_gpu), ParseqPredictor(pq_cpu)
    crops = torch.from_numpy(rs.uniform(0, 1, (16, 32, 128, 3)).astype(np.float32))
    crops_dev = crops.to(dev)
    with torch.no_grad():
        logits_gpu = read_gpu.read_logits(crops_dev)
        logits_cpu = read_cpu.read_logits(crops)
        read_ms = time_ms(lambda: read_gpu.read_logits(crops_dev), reps=10)
    err = rel_l2(logits_gpu, logits_cpu)
    abs_err = float((logits_gpu.cpu() - logits_cpu).abs().max())
    top2 = logits_cpu.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 4 * abs_err
    ids_gpu, ids_cpu = logits_gpu.argmax(-1).cpu(), logits_cpu.argmax(-1)
    agree = float((ids_gpu == ids_cpu).float().mean())
    texts = read_gpu.img2txt(crops_dev)
    log(f"[ocr] PARSeq-base full read (26 greedy steps + refinement) of 16 crops, fp32: card "
        f"against CPU logits relative L2 {err:.3e} (tol 1e-4), max abs {abs_err:.3e}; greedy ids "
        f"agree at {agree:.4f} of positions ({int(clear.sum())} of {clear.numel()} with a top-2 "
        f"gap past 4× the max error, all must agree); {read_ms:.2f} ms per batch of 16; "
        f"texts {texts[:3]}")
    if not (err <= 1e-4 and torch.equal(ids_gpu[clear], ids_cpu[clear])
            and tuple(logits_gpu.shape) == (16, 26, 95)):
        fail("PARSeq on the card disagrees with the CPU")
    # calc_loss and its gradient with respect to the images, B=2 at 512²; the
    # head is shifted toward 'a' so that the words of 'a' score under the 1.0
    # clamp and carry a gradient
    with torch.no_grad():
        for m in (pq_cpu, pq_gpu):
            m.head.bias[read_cpu.tokenizer.stoi["a"]] += 8.0
    images = torch.from_numpy(rs.uniform(-1.1, 1.1, (2, 512, 512, 3)).astype(np.float32))
    bbox = torch.tensor([[200, 264, 100, 356], [0, 512, 0, 512]], dtype=torch.int32)
    labels = torch.from_numpy(read_cpu.tokenizer.encode(["aaaa", "aaaaaaa"]))

    def loss_and_grad(pred, im):
        x = im.clone().requires_grad_(True)
        value = pred.calc_loss(x, bbox, labels)
        value.sum().backward()
        return value.detach(), x.grad

    loss_gpu, grad_gpu = loss_and_grad(read_gpu, images.to(dev))
    loss_cpu, grad_cpu = loss_and_grad(read_cpu, images)
    loss_ms = time_ms(lambda: loss_and_grad(read_gpu, images.to(dev)), reps=5)
    loss_err = float(((loss_gpu.cpu() - loss_cpu).abs() / loss_cpu.abs()).max())
    grad_err = rel_l2(grad_gpu, grad_cpu)
    log(f"[ocr] calc_loss (B=2, 512², bboxes 64×256 and the whole image) {loss_cpu.tolist()}: "
        f"card against CPU value {loss_err:.3e} relative (tol 1e-4), image gradient relative "
        f"L2 {grad_err:.3e} (tol 1e-4); {loss_ms:.2f} ms for the loss and its gradient")
    if not (float(loss_cpu.max()) < 1.0 and loss_err <= 1e-4 and grad_err <= 1e-4
            and float(grad_cpu.abs().max()) > 0):
        fail("calc_loss or its image gradient on the card disagrees with the CPU")
    del pq_cpu, pq_gpu, read_gpu, read_cpu, crops_dev, images, grad_gpu, grad_cpu

    # (b) the OCR-loss fine-tuning step at full width: the shipped train graph
    # with ocr_enabled, seeded random weights, synthetic 512² samples collated
    # by the port's loader. (c) The micro-batch is the largest power of two
    # that fits in 80 GB (scripts/ocr_train_probe.py): the fp32 decoder keeps
    # its activations for the OCR term's backward
    steps, accum, micro_b = 3, 4, OCR_MICRO_BATCH
    t0 = time.perf_counter()
    bundle = build_engine(ocr_train_graph(), torch.bfloat16, dev, train=True)
    engine = bundle.engine
    randomize_parameters(engine, 0)
    frozen = {n: p.detach().cpu().clone() for n, p in engine.named_parameters()
              if not p.requires_grad}
    trained = {n: p.detach().cpu().clone() for n, p in engine.named_parameters()
               if p.requires_grad}
    batches = SyntheticBatches(accum, micro_b, seed=1)
    log(f"[ocr_train] engine with PARSeq-base (fp32, frozen) and {len(batches)} collated "
        f"micro-batches of {micro_b} (keys {sorted(batches.batches[0])}) ready in "
        f"{time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory(prefix="udt_ocr_train_") as log_dir:
        cfgs = {"batch_size": micro_b, "base_learning_rate": 5e-5, "log_dir": log_dir,
                "lightning": {"accumulate_grad_batches": accum, "max_epochs": steps}}
        reset(*kernel_fns)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train(cfgs, batches, bundle, seed=0, log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = by_path["ocr_train"] = counts(*kernel_fns)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        with open(f"{log_dir}/train_metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
    step_s = [b_["time"] - a_["time"] for a_, b_ in zip(rows, rows[1:])]
    log(f"[ocr_train] {steps} optimizer steps of {accum}×{micro_b} samples with the OCR term "
        f"in {train_s:.3f} s; s per step after the first {[round(x_, 3) for x_ in step_s]}, "
        f"{accum * micro_b / step_s[-1]:.2f} samples/s; peak device memory {peak:.2f} GiB; "
        f"launches {launches}; losses "
        f"{[{k: round(v, 5) for k, v in r.items() if 'loss' in k} for r in rows]}")
    for row in rows:
        vals = {k: v for k, v in row.items() if k.startswith("loss")}
        if set(vals) != {"loss", "loss/diff_loss", "loss/local_loss", "loss/ocr_loss",
                         "loss/full_loss"} or not all(np.isfinite(v) for v in vals.values()) \
                or not vals["loss/ocr_loss"] > 0:
            fail(f"OCR-step loss components {vals}")
    if state.step != steps:
        fail(f"{state.step} optimizer steps, expected {steps}")
    changed = [n for n, p in engine.named_parameters()
               if not p.requires_grad and not torch.equal(p.detach().cpu(), frozen[n])]
    if (changed or any(p.grad is not None for p in engine.parameters() if not p.requires_grad)
            or not any(n.startswith("parseq.") for n in frozen)):
        fail(f"frozen parameters (PARSeq and the VAE among them) changed or got gradients: "
             f"{changed[:5]}")
    still = [n for n, p in engine.named_parameters()
             if p.requires_grad and torch.equal(p.detach().cpu(), trained[n])]
    if still:
        fail(f"trainable parameters did not move: {still[:5]}")
    micro = steps * accum  # the layer plan of phase 6: the OCR term adds no UNet eval
    want = expected(flash_attention=micro * 10, flash_attention_bwd=micro * 9,
                    geglu_ff=micro * 15)
    if launches != want:
        fail(f"OCR-step launches {launches}, predicted {want}")
    # random PARSeq weights read every word at a CE past the 1.0 clamp, where
    # the term's gradient is 0. With the head shifted toward 'a' and words of
    # 'a', the term alone is differentiated to the trainable parameters
    with torch.no_grad():
        engine.parseq.head.bias[engine.ocr_predictor.tokenizer.stoi["a"]] += 8.0
    mb = to_device(batches.batches[0], dev)
    mb["parseq_label_ids"] = torch.from_numpy(
        engine.ocr_predictor.tokenizer.encode(["aaaa"] * micro_b)).to(dev)
    engine.zero_grad(set_to_none=True)
    _, parts = engine.loss(mb, torch.Generator(dev).manual_seed(5))
    parts["loss/ocr_loss"].backward()
    parts = {k: v.detach() for k, v in parts.items()}
    grads = [p.grad for p in engine.parameters() if p.requires_grad]
    ocr_norm = float(torch.stack([g.float().norm() for g in grads if g is not None]).norm())
    reached = sum(g is not None and bool(g.abs().sum() > 0) for g in grads)
    log(f"[ocr_train] the OCR term alone on words of 'a' (head shifted +8 toward 'a'): "
        f"{float(parts['loss/ocr_loss']):.5f}; its gradient reaches {reached} of "
        f"{len(grads)} trainable tensors, norm {ocr_norm:.4e}")
    if not (0 < float(parts["loss/ocr_loss"]) < 1.0 and np.isfinite(ocr_norm) and reached > 0
            and not any(p.grad is not None for p in engine.parameters() if not p.requires_grad)):
        fail("the OCR term's gradient did not reach the trainable parameters")
    engine.zero_grad(set_to_none=True)
    del mb, parts, grads
    with tempfile.TemporaryDirectory(prefix="udt_ocr_train_") as log_dir:
        one = {"batch_size": micro_b, "base_learning_rate": 5e-5, "log_dir": log_dir,
               "lightning": {"accumulate_grad_batches": accum, "max_epochs": 1}}
        profile_groups(f"one optimizer step with the OCR term ({accum}×{micro_b})",
                       lambda: train(one, batches, bundle, seed=1, log_every=1), step_s[-1])
        # the same step without the OCR term, on the same engine and batches
        engine.loss_cfg = dataclasses.replace(engine.loss_cfg, ocr_enabled=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train(one, batches, bundle, seed=1, log_every=1)
        torch.cuda.synchronize()
        off_s = time.perf_counter() - t0
    log(f"[ocr_train] one optimizer step without the OCR term {off_s:.3f} s: the term takes "
        f"{1.0 - off_s / step_s[-1]:.3f} of a step with it")
    del engine, bundle, state, frozen, trained, batches
    torch.cuda.empty_cache()

    # 8. the glue-fusion probe, and the fused block against the unfused one
    calls = 1 + 5 * 20  # per label: one warm-up, then 5 timed runs of K=20
    reset(*kernel_fns)
    probe = glue_fusion_probe.run(batch=16, reps=20, device=str(dev))
    torch.cuda.synchronize()
    launches = by_path["glue_probe"] = counts(*kernel_fns)
    # per shape: ln_gemm in section F; ln_gemm3 in F and the fused block; the
    # t_attn kernel in G and the fused block; geglu_ff_ln in the fused block,
    # geglu_ff in the two unfused ones; flash in A (twice) and all three blocks
    want = expected(flash_attention=2 * 5 * calls, geglu_ff=2 * 2 * calls, ln_gemm=2 * calls,
                    ln_gemm3=2 * 2 * calls, fused_cross_attention=2 * 2 * calls,
                    geglu_ff_ln=2 * calls)
    log(f"[glue_probe] {len(probe)} labels at B=32, K=20; launches {launches}")
    if launches != want:
        fail(f"glue probe launches {launches}, expected {want}")
    if len(probe) != 28 or not all(np.isfinite(v) and v > 0 for v in probe.values()):
        fail(f"glue probe returned {len(probe)} labels of 28, or a time that is not positive")

    train_keys = ("t_attn", "t_norm")
    fused_fns = (ln_gemm3, fused_cross_attention, geglu_ff_ln, flash_attention, geglu_ff)
    for name, n, c in (("ds1", 4096, 320), ("ds2", 1024, 640)):
        heads = c // 64
        plain_cpu = randomize_parameters(BasicTransformerBlock(heads, 64, 2048), 3).eval()
        plain = cast_weights(BasicTransformerBlock(heads, 64, 2048), torch.bfloat16,
                             keep_fp32=train_keys).to(dev).eval()
        fused = cast_weights(BasicTransformerBlock(heads, 64, 2048, fuse_qkv=True,
                                                   fuse_glue="auto"), torch.bfloat16,
                             keep_fp32=train_keys).to(dev).eval()
        plain.load_state_dict(plain_cpu.state_dict())
        fused.load_state_dict(plain_cpu.state_dict())
        rs8 = np.random.RandomState(8)
        xb = torch.from_numpy(rs8.standard_normal((2, n, c)).astype(np.float32))
        ctx = torch.from_numpy(rs8.standard_normal((2, 12, 2048)).astype(np.float32))
        r_out = torch.from_numpy(rs8.standard_normal((2, n, c)).astype(np.float32)).to(dev)
        x16, ctx16 = xb.to(dev, torch.bfloat16), ctx.to(dev, torch.bfloat16)
        with torch.no_grad():
            kv = {"t": fused.t_attn.project_kv(ctx16)}
            reset(*fused_fns)
            got, no_map = fused(x16, ctx16, None, False, kv)
            per_fwd = counts(*fused_fns)
            want16, _ = plain(x16, ctx16, None, False, kv)
            reset(*fused_fns)
            _, t_map = fused(x16, ctx16, None, True, kv)
            with_map = counts(*fused_fns)
            _, want_map = plain(x16, ctx16, None, True, kv)
        torch.cuda.synchronize()
        rel = rel_l2(got, want16)
        map_err = float((t_map - want_map).abs().max())
        log(f"[fused-block] {name} BasicTransformerBlock(fuse_qkv=True, fuse_glue='auto') vs "
            f"(False, 'off'), bf16, hoisted K/V: relative L2 {rel:.3e} (tol 2e-2: bf16 rounds at "
            f"other points in the two); launches per forward {per_fwd}; with capture_map "
            f"{with_map}, map {tuple(t_map.shape)} max err {map_err:.3e} (tol 2e-2)")
        if not (torch.isfinite(got).all() and rel <= 2e-2 and no_map is None):
            fail(f"the fused {name} block disagrees with the unfused one")
        if per_fwd != {"ln_gemm3": 1, "fused_cross_attention": 1, "geglu_ff_ln": 1,
                       "flash_attention": 1, "geglu_ff": 0}:
            fail(f"fused {name} block launches {per_fwd}")
        if (with_map["fused_cross_attention"] != 0 or tuple(t_map.shape) != (2, heads, n, 12)
                or map_err > 2e-2):
            fail(f"fused {name} block with capture_map: launches {with_map}, map "
                 f"{tuple(t_map.shape)}, error {map_err}")
        if name == "ds1":
            with torch.no_grad():
                want32, _ = plain_cpu(xb, ctx, None, False, {"t": plain_cpu.t_attn.project_kv(ctx)})
            rel = rel_l2(got, want32)
            log(f"[fused-block] ds1 fused block bf16 GPU vs fp32 CPU: relative L2 {rel:.3e} "
                f"(tol 2e-2)")
            if not rel <= 2e-2:
                fail("the fused ds1 block disagrees with its fp32 CPU run")

        # one backward through the fused block against the unfused one's
        grads = {}
        for key, blk in (("fused", fused), ("plain", plain)):
            for pn, prm in blk.named_parameters():
                prm.requires_grad_(any(k in pn for k in train_keys))
                prm.grad = None
            x_in = x16.clone().requires_grad_(True)
            out, _ = blk(x_in, ctx16, None, False, {"t": blk.t_attn.project_kv(ctx16)})
            (out.float() * r_out).sum().backward()
            grads[key] = {"input": x_in.grad, **{pn: p.grad for pn, p in blk.named_parameters()
                                                 if p.requires_grad}}
        torch.cuda.synchronize()
        errs = {k: rel_l2(grads["fused"][k], grads["plain"][k]) for k in grads["plain"]}
        worst = max(errs, key=errs.get)
        log(f"[fused-block] {name} gradients, fused vs unfused: relative L2 input "
            f"{errs['input']:.3e}, worst of {len(errs) - 1} t_attn/t_norm weights "
            f"{errs[worst]:.3e} ({worst}) (tol 3e-2)")
        if not (len(errs) == 8 and all(e <= 3e-2 for e in errs.values())
                and all(torch.isfinite(g_).all() for g_ in grads["fused"].values())):
            fail(f"the fused {name} block's gradients disagree with the unfused block's")
        del plain_cpu, plain, fused, grads
        torch.cuda.empty_cache()

    # 9. the ResBlock probe: the fused GroupNorm+SiLU against the eager glue
    reps, runs = 20, 5
    calls = 1 + runs * reps  # per label: one warm-up, then the timed runs
    reset(*kernel_fns)
    probe = resblock_probe.run(batch=32, channels=320, reps=reps, runs=runs, device=str(dev))
    torch.cuda.synchronize()
    launches = by_path["resblock_probe"] = counts(*kernel_fns)
    # two wrapper calls per fused ResBlock call, one per glue call, one for the difference
    want = expected(fused_groupnorm_silu=2 * calls + calls + 1)
    gn_plan = fused_groupnorm_silu.last_plan
    log(f"[resblock_probe] {len(probe)} labels at B=32, C=320, K={reps}; launches {launches}; "
        f"route {gn_plan.route}, {gn_plan.launches} device launch(es) a call")
    if gn_plan.route != "cluster" or gn_plan.launches != 1:
        fail(f"the ResBlock probe's GroupNorm ran on {gn_plan}, not one cluster launch a call")
    if launches != want:
        fail(f"ResBlock probe launches {launches}, expected {want}")
    diff = probe.pop(resblock_probe.DIFF_LABEL)
    if len(probe) != 5 or not all(np.isfinite(v) and v > 0 for v in probe.values()):
        fail(f"ResBlock probe returned {len(probe)} timed labels of 5, or a time that is not positive")
    if not diff <= 2**-7 * 8:  # two bf16 ulps of a normalized activation below 8
        fail(f"ResBlock probe: eager and fused glue differ by {diff}")

    # 10. the flash-variants probe
    reps, runs = 5, 3
    calls = 1 + 1 + runs * reps  # per label: the oracle check, one warm-up, the timed runs
    reset(*kernel_fns)
    probe = variants_probe.run(reps=reps, runs=runs, device=str(dev))
    torch.cuda.synchronize()
    launches = by_path["flash_variants"] = counts(*kernel_fns)
    pairs = len(TILE_MENU[torch.bfloat16])
    want = expected(flash_attention=calls,
                    **{f"flash_variant_{name}": pairs * calls for name in VARIANTS})
    log(f"[flash_variants] {len(probe)} labels at B·H=160, N=4096, K={reps}; launches {launches}")
    if launches != want:
        fail(f"flash-variants probe launches {launches}, expected {want}")
    if len(probe) != 2 + 4 * pairs or not all(
            np.isfinite(ms) and ms > 0 and np.isfinite(tf) for ms, tf in probe.values()):
        fail(f"flash-variants probe returned {len(probe)} labels of {2 + 4 * pairs}, or a time "
             "that is not positive")

    # 11. serving: the port's serve_bench entry at full width with the demo's
    # sampler (configs/demo.yaml: 50 steps, CFG 4.0, 10 candidates, batched
    # search), buckets (1, 8), pipeline depth 2: 2 saturated groups of 8 and 2
    # single requests, 512² uint8
    reset(*kernel_fns)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bench = serve_bench.run(max_batch=8, steps=50, noise_iters=10, batches=2, qps=0.5,
                            latency_requests=2, buckets=(1, 8), noise_search_batched=True,
                            pipeline=2, cfg_scale=4.0, device=str(dev))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = by_path["serve"] = counts(*kernel_fns)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rec, sat, lat = bench.record, bench.saturated, bench.latency
    # a warmup group per bucket, then the batcher's groups: 52 UNet evals a
    # group whatever its bucket (2 batched search evals, 50 steps)
    groups = (len(rec["buckets"]) + rec["saturated_batcher_stats"]["batches"]
              + rec["batcher_stats"]["batches"])
    log(f"[serve] {rec['metric']} {rec['value']:.4f} samples/s (2 groups of 8, saturated); "
        f"single requests {', '.join(f'{x:.3f}' for x in rec['latency_s'])} s (bucket 1); "
        f"mean batch size {rec['saturated_batcher_stats']['mean_batch_size']:.2f}; "
        f"run stat (finalize) p50 {rec['saturated_batcher_stats']['run']['p50_s']:.3f} s; "
        f"warmup {rec['compile_s']:.2f} s; launch-to-finalize overlap "
        f"{rec['overlap']['overlapped_s']:.3f} of {rec['overlap']['launch_s']:.3f} s of the later "
        f"group's launch ({rec['overlap']['share']:.3f}); peak device memory {peak:.2f} GiB; "
        f"{groups} groups in {serve_s:.2f} s; launches {launches}")
    log(f"[serve] record {json.dumps(rec)}")
    if launches != expected(flash_attention=groups * 520, geglu_ff=groups * 780):
        fail(f"serving launches {launches} over {groups} groups, expected 520 flash forwards and "
             "780 GEGLU forwards a group")
    images = [r["image"] for r in sat + lat]
    if not all(im.dtype == np.uint8 and im.shape == (512, 512, 3) and im.std() > 0
               for im in images):
        fail("serving outputs are not non-constant (512, 512, 3) uint8 images")
    sat_keys = sorted({r["batch_key"] for r in sat})
    if (len(sat_keys) != 2
            or sorted((r["batch_key"], r["row"]) for r in sat)
            != [(k, i) for k in sat_keys for i in range(8)]
            or any(r["batch_size"] != 8 for r in sat)
            or [(r["row"], r["batch_size"]) for r in lat] != [(0, 1), (0, 1)]
            or len({r["batch_key"] for r in lat}) != 2
            or rec["saturated_batcher_stats"]["mean_batch_size"] != 8.0):
        fail(f"replay coordinates: saturated {[(r['batch_key'], r['row'], r['batch_size']) for r in sat]}, "
             f"single {[(r['batch_key'], r['row'], r['batch_size']) for r in lat]}")
    # one group replayed from its coordinates: same rows, same key, same bucket
    helper = bench.make_service(1.0)
    row = helper.build_row(bench.request)
    replay_batch = helper.batch_of([row] * 8)
    helper.shutdown()
    # (under torch.profiler: the device's share of a saturated group's time)
    replayed = {}
    profile_groups("serving, one bucket-8 group (the replay)",
                   lambda: replayed.setdefault("images", bench.predict(replay_batch, sat_keys[0])
                                               .cpu().numpy()), 8 / rec["value"])
    again = replayed["images"]
    differ = [r["row"] for r in sat
              if r["batch_key"] == sat_keys[0] and not np.array_equal(again[r["row"]], r["image"])]
    log(f"[serve] group {sat_keys[0]} replayed from (contents, batch_key, batch_size): "
        f"{8 - len(differ)} of 8 rows bit-equal")
    if differ:
        fail(f"the replayed group differs in rows {differ}")
    # a UNet eval at bucket 8 (CFG-doubled batch 16) with kernels against plain
    auto_eng = bench.predict.predictor.engine
    plain_eng = build_engine(TEXTDESIGN_SD_2, torch.bfloat16, dev, attn_impl="plain").engine
    randomize_parameters(plain_eng, 0)  # the weights serve_bench gives its engine
    x16, t16, c16 = randn(16, 64, 64, 9), torch.full((16,), 0.3, device=dev), randn(16, 12, 2048)
    outs, eval_counts = {}, {}
    with torch.no_grad():
        for name, eng in (("auto", auto_eng), ("plain", plain_eng)):
            reset(*kernel_fns)
            outs[name] = eng.unet(x16, t16, c16, None)[0]
            torch.cuda.synchronize()
            eval_counts[name] = counts(*kernel_fns)
    b8_err = rel_l2(outs["auto"], outs["plain"])
    log(f"[serve] one UNet eval at bucket 8 (B=16, bf16): relative L2 kernels vs plain "
        f"{b8_err:.3e} (tol 5e-2, as phase 5b); launches auto {eval_counts['auto']}")
    if not (b8_err <= 5e-2 and eval_counts["auto"] == expected(flash_attention=10, geglu_ff=15)
            and eval_counts["plain"] == expected() and torch.isfinite(outs["plain"]).all()):
        fail("the bucket-8 UNet eval with kernels disagrees with the plain one")
    del plain_eng, outs, x16, c16
    # the batcher's two faults the port must not have, on the card: a request
    # cancelled while queued, then shutdown with the depth-2 pipeline full
    svc = InpaintService(bench.predict, max_batch=1, max_delay_ms=0.0, size=512, pipeline_depth=2)
    t0 = time.perf_counter()
    first, cancelled, last = (svc.submit(bench.request) for _ in range(3))
    was_cancelled = cancelled.cancel()
    svc.shutdown()
    fault_s = time.perf_counter() - t0
    alive = svc.batcher._thread.is_alive() or svc.batcher._completion_thread.is_alive()
    done = [f.result(timeout=0) for f in (first, last)]
    log(f"[serve] a request cancelled while queued, then shutdown under a full pipeline: "
        f"cancelled {was_cancelled}, the other two served as groups {[r['batch_key'] for r in done]} "
        f"in {fault_s:.2f} s, threads left {alive}, errors {svc.stats()['errors']}")
    if not (was_cancelled and cancelled.cancelled() and not alive
            and [r["batch_key"] for r in done] == [0, 1] and svc.stats()["errors"] == 0
            and all(r["image"].shape == (512, 512, 3) for r in done)):
        fail("serving: a cancelled request or a shutdown under a full pipeline went wrong")
    del bench, auto_eng, svc, done, again
    torch.cuda.empty_cache()

    # 12. the eval CLI (udifftext_tpu_torch.test): configs/test.yaml's run at
    # full width (CFG 5.0, 50 steps, batch 1, 10 candidates in the sequential
    # search, which test.yaml keeps), 3 synthetic 512² batches with name, label
    # and r_bbox, OCR through a PARSeq file of seeded random weights, then FID
    # and LPIPS (quan_test) through metrics weight files of seeded random weights
    from udifftext_tpu_torch import test as eval_cli
    from udifftext_tpu_torch.data.loader import collate
    from udifftext_tpu_torch.data.synthetic import synthetic_sample
    from udifftext_tpu_torch.utils.png import read_png
    from udifftext_tpu_torch.utils.viz import average_attn_maps, save_segment_map

    with tempfile.TemporaryDirectory(prefix="udt_eval_") as work:
        parseq_path = f"{work}/parseq.pt"
        torch.save(randomize_parameters(PARSeq(), 0).state_dict(), parseq_path)
        cfgs = eval_run_config(work, parseq_path)
        os.environ.update(write_metric_weights(work))
        bundle = loading.init_model(cfgs, dev, seed=0, model_cfg=TEXTDESIGN_SD_2)
        sampler = loading.init_sampling(cfgs)
        rs_eval = np.random.RandomState(12)
        loader = []
        for i in range(cfgs["max_iter"]):
            loader.append(collate([synthetic_sample(rs_eval, 512)]))
            loader[-1]["name"] = [f"eval{i}"]
        reset(*kernel_fns)
        held = torch.cuda.memory_allocated(dev) / 2**30  # the engine and what earlier phases hold
        torch.cuda.reset_peak_memory_stats(dev)
        tee = Tee(sys.stdout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            res = eval_cli.test(bundle, sampler, loader, cfgs, seed=0)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = by_path["eval_cli"] = counts(*kernel_fns)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for k in METRIC_ENV:
            os.environ.pop(k)
        accuracy = re.search(r"OCR test completed\. Mean accuracy: (\S+)", tee.text())
        fid_line = re.search(r"^FID: (\S+)$", tee.text(), re.M)
        lpips_line = re.search(r"^lpips score: (\S+)$", tee.text(), re.M)
        shapes = {}
        for name in res["names"]:
            for rel in (f"real/{name}.png", f"fake/{name}.png", f"{name}.png"):
                shapes[rel] = read_png(f"{cfgs['output_dir']}/{rel}").shape
        log(f"[eval_cli] {len(res['names'])} batches of 1 (512², 10 candidates in the sequential "
            f"search, 50 steps, CFG 5.0, PARSeq read of the box): s per sample (sampling to "
            f"written files) {[round(x_, 3) for x_ in res['seconds']]}, median "
            f"{statistics.median(res['seconds']):.3f}; {eval_s:.2f} s in all; peak device memory "
            f"{peak:.2f} GiB ({held:.2f} GiB allocated before the run); OCR "
            f"{res['correct']}/{res['total']}; quan_test: FID {res.get('fid')}, LPIPS "
            f"{res.get('lpips')} (seeded random Inception and AlexNet: they check the "
            f"mechanism only); launches {launches}")
        # the sequential search runs 2 UNet evals a candidate, then the 50 steps
        evals = 2 * cfgs["noise_iters"] + cfgs["steps"]
        want = expected(flash_attention=len(loader) * evals * 10,
                        geglu_ff=len(loader) * evals * 15)
        if launches != want:
            fail(f"eval CLI launches {launches}, predicted {want} ({evals} UNet evals a sample)")
        if accuracy is None or res["total"] != len(loader):
            fail(f"eval CLI: no accuracy line, or {res['total']} OCR reads of {len(loader)}")
        scores = (res.get("fid"), res.get("lpips"))
        if (fid_line is None or lpips_line is None
                or any(v is None or not np.isfinite(v) for v in scores)):
            fail(f"eval CLI quan_test: FID line {fid_line}, LPIPS line {lpips_line}, "
                 f"values {res.get('fid')}, {res.get('lpips')}")
        want_shapes = {rel: (2048 if "/" not in rel else 512, 512, 3) for rel in shapes}
        if res["names"] != [b_["name"][0] for b_ in loader] or shapes != want_shapes:
            fail(f"eval CLI files: {shapes}")
        # one sample with attend-and-excite and map capture, through the CLI's
        # functions (the GIF and the map grid need imageio and matplotlib, which
        # this machine lacks: the CPU tests hold them)
        aae_cfgs = {**cfgs, "aae_enabled": True, "detailed": True}
        pipeline = eval_cli.make_predictor(aae_cfgs, bundle, sampler)
        reset(*kernel_fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, aux = eval_cli.predict(aae_cfgs, pipeline, loader[0],
                                       torch.Generator(dev).manual_seed(0))
        maps = average_attn_maps({k: v.float().cpu().numpy() for k, v in aux.items()
                                  if k.endswith("t_attn")}, layers=bundle.save_attn_layers)
        label = loader[0]["label"][0]
        seg = np.load(save_segment_map(maps, label, f"{work}/temp/seg_map/seg_eval0.npy"))
        aae_s = time.perf_counter() - t0
        launches = counts(*kernel_fns)
        n_aae = launches["flash_attention_bwd"] // 10
        log(f"[eval_cli] one sample with attend-and-excite and map capture: {aae_s:.3f} s, "
            f"{n_aae} AAE gradient evaluations, layers {bundle.save_attn_layers}, segment map "
            f"{seg.shape} for '{label}'; launches {launches}")
        evals += n_aae
        if not (n_aae >= 50 and launches == expected(flash_attention=evals * 10,
                                                     flash_attention_bwd=n_aae * 10,
                                                     geglu_ff=evals * 15)):
            fail(f"eval CLI AAE launches {launches}")
        if (images.shape != (1, 512, 512, 3) or not np.isfinite(images).all()
                or seg.shape != (len(label), 32, 32) or not np.isfinite(seg).all()
                or tuple(aux["local_losses"].shape) != (50, 1)):
            fail(f"eval CLI AAE outputs: images {images.shape}, segment map {seg.shape}")
    del bundle, pipeline, images, aux, maps, loader
    torch.cuda.empty_cache()

    # 13. the train CLI (udifftext_tpu_torch.train.main): configs/train.yaml's
    # run at full width (batch 16, accumulate 4) on synthetic batches, two
    # optimizer steps an epoch, 2 epochs, a checkpoint each epoch (1 kept), image
    # logs every 2 updates, EMA on, in a world-size-1 NCCL process group (the
    # gradient all-reduce runs); then a second run on the same directory
    # resumes and takes one more epoch
    from udifftext_tpu_torch import train as train_cli
    from udifftext_tpu_torch.parallel.train import TrainState
    from udifftext_tpu_torch.utils.profiling import SimpleProfiler
    from udifftext_tpu_torch.utils.train_ckpt import restore_checkpoint

    accum, micro_b = TRAIN_RUN["lightning"]["accumulate_grad_batches"], TRAIN_RUN["batch_size"]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
                      LOCAL_RANK="0")
    with tempfile.TemporaryDirectory(prefix="udt_train_cli_") as work:
        cfgs = train_run_config(work)
        per_epoch = 2
        batches = SyntheticBatches(per_epoch * accum, micro_b, seed=13)
        prof = SimpleProfiler()
        reset(*kernel_fns)
        held = torch.cuda.memory_allocated(dev) / 2**30  # what earlier phases hold
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train_cli.main(cfgs, batches, device=dev, model_cfg=TEXTDESIGN_SD_2_TRAIN,
                               seed=0, log_every=1, profiler=prof)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = by_path["train_cli"] = counts(*kernel_fns)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        group = (torch.distributed.get_backend(), torch.distributed.get_world_size()) \
            if torch.distributed.is_initialized() else None
        ckpt_dir = f"{work}/ckpt/{train_cli.CKPT_SUBDIR}"
        files = sorted(os.listdir(ckpt_dir))
        images_dir = f"{cfgs['log_dir']}/images"
        image_logs = sorted(os.listdir(images_dir)) if os.path.isdir(images_dir) else []
        with open(f"{cfgs['log_dir']}/train_metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        steps = per_epoch * cfgs["lightning"]["max_epochs"]
        step_s = rows[1]["time"] - rows[0]["time"]  # within epoch 0: no save between
        size_gib = os.path.getsize(f"{ckpt_dir}/{files[-1]}") / 2**30 if files else 0.0
        blocked, writes = prof.totals["checkpoint"], prof.totals["checkpoint_write (background)"]
        log(f"[train_cli] {steps} optimizer steps ({accum}×{micro_b}) in 2 epochs in "
            f"{run_s:.2f} s (engine build, image logs and checkpoints included); s per step "
            f"(step 1 to 2) {step_s:.3f}, {accum * micro_b / step_s:.2f} samples/s; process "
            f"group {group}; "
            f"checkpoints {files} of {size_gib:.3f} GiB; the loop blocked in save "
            f"{blocked:.3f} s over {prof.counts['checkpoint']} saves against {writes:.3f} s of "
            f"writing on the background thread; image logs {prof.totals['image_logs']:.2f} s; "
            f"peak device memory {peak:.2f} GiB ({held:.2f} GiB allocated before the run), peak "
            f"host RSS {peak_rss_gib():.2f} GiB; launches {launches}")
        if group != ("nccl", 1):
            fail(f"the train CLI ran without a world-size-1 NCCL group: {group}")
        if state.step != steps or files != [f"step_{steps:08d}.pt"]:
            fail(f"train CLI: step {state.step}, checkpoint files {files}")
        want_logs = [f"step{s_:07d}_{k}.png" for s_ in range(2, steps + 1, 2)
                     for k in ("inputs", "reconstructions", "samples")]
        if image_logs != want_logs or any(read_png(f"{images_dir}/{n_}").shape != (512, 2048, 3)
                                          for n_ in image_logs):
            fail(f"train CLI image logs {image_logs}")
        # per micro-batch 10 / 9 / 15 (phase 6); an image log's 20 sampling evals
        # (noise_iters 0, no backward) 10 / 0 / 15 each, one log every 2 updates
        train_part = steps * accum
        log_evals = 20 * (steps // 2)
        want = expected(flash_attention=train_part * 10 + log_evals * 10,
                        flash_attention_bwd=train_part * 9,
                        geglu_ff=train_part * 15 + log_evals * 15)
        if launches != want:
            fail(f"train CLI launches {launches}, predicted {want} ({train_part} micro-batches, "
                 f"{log_evals} image-log evals)")
        for row in rows:
            if not all(np.isfinite(v) for k, v in row.items() if k.startswith("loss")):
                fail(f"train CLI loss components {row}")
        # the checkpoint against a fresh engine of the same seed (run 1's start):
        # frozen parameters bit-identical, trainable ones moved; restored into it,
        # parameters, AdamW moments and EMA bit-equal to run 1's final state
        path = f"{ckpt_dir}/{files[-1]}"
        fresh = loading.init_model(cfgs, dev, seed=0, model_cfg=TEXTDESIGN_SD_2_TRAIN, train=True)
        saved = torch.load(path, map_location="cpu", mmap=True, weights_only=True)["engine"]
        moved = still = frozen_diff = 0
        for n_, p_ in fresh.engine.named_parameters():
            same = torch.equal(saved[n_], p_.detach().cpu())
            if p_.requires_grad:
                moved += not same
                still += same
            else:
                frozen_diff += not same
        fresh_state = TrainState.create(fresh.engine, use_ema=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(path, fresh.engine, fresh_state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        opt_a, opt_b = state.optimizer.state_dict()["state"], \
            fresh_state.optimizer.state_dict()["state"]
        unequal = ([n_ for n_, p_ in state.params.items()
                    if not torch.equal(p_, fresh_state.params[n_])
                    or not torch.equal(state.ema[n_], fresh_state.ema[n_])]
                   + [i for i, st in opt_a.items()
                      if any(not torch.equal(v, opt_b[i][k]) for k, v in st.items())])
        log(f"[train_cli] restored into a fresh engine in {restore_s:.2f} s: {len(unequal)} "
            f"parameters, EMA entries or AdamW states differ from run 1's; against run 1's "
            f"start {frozen_diff} frozen parameters differ, {moved} trainable moved, {still} not")
        if unequal or fresh_state.step != state.step:
            fail(f"restored state differs: {unequal[:5]}, step {fresh_state.step}")
        if frozen_diff or still or not moved:
            fail("frozen parameters changed, or trainable ones did not move")
        del fresh, fresh_state, saved, state, opt_a, opt_b
        torch.cuda.empty_cache()
        # run 2: the same directory, another seed, one more epoch
        prof2 = SimpleProfiler()
        reset(*kernel_fns)
        tee = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            state = train_cli.main(train_run_config(work, max_epochs=1), batches, device=dev,
                                   model_cfg=TEXTDESIGN_SD_2_TRAIN, seed=1, log_every=1,
                                   profiler=prof2)
        torch.cuda.synchronize()
        launches = counts(*kernel_fns)
        files = sorted(os.listdir(ckpt_dir))
        log(f"[train_cli] resumed run: step {state.step}, restore {prof2.totals['restore']:.2f} "
            f"s, checkpoint files {files}; launches {launches}")
        if (f"resuming from {path} at step {steps}" not in tee.text()
                or state.step != steps + per_epoch or files != [f"step_{state.step:08d}.pt"]):
            fail(f"train CLI resume: step {state.step}, files {files}")
        # one epoch: per_epoch steps and the image log at its last step
        if launches != expected(flash_attention=(per_epoch * accum + 20) * 10,
                                flash_attention_bwd=per_epoch * accum * 9,
                                geglu_ff=(per_epoch * accum + 20) * 15):
            fail(f"resumed train CLI launches {launches}")
        del state, batches
    torch.cuda.empty_cache()

    # 15. LabelEncoder pretraining and the metrics. (a) configs/pretrain.yaml's
    # LabelEncoderPretrain at full width (seeded random weights) against a
    # frozen ViTSTR-base, 5 steps at batch 256 of synthetic label images
    # through pretrain.train, inside phase 13's world-size-1 NCCL group (the
    # contrastive features go through the all-gather); then 20 steps on one
    # fixed batch of 32, where the loss must fall
    from udifftext_tpu_torch import metrics, pretrain
    from udifftext_tpu_torch.data.synthetic import SyntheticLabelBatches
    from udifftext_tpu_torch.diffusion.loss import clip_contrastive_loss
    from udifftext_tpu_torch.parallel.dist import all_gather_rows

    pre_cfgs = copy.deepcopy(PRETRAIN_RUN)
    pre_mp = pre_cfgs["model"]["params"]
    emb = pre_mp["emb_dim"]
    label_shape = dict(size=pre_mp["visual_config"]["params"]["size"], max_len=pre_mp["max_len"])
    pre_b, pre_steps = pre_cfgs["batch_size"], 5
    pre_batches = SyntheticLabelBatches(pre_steps, pre_b, seed=15, **label_shape)
    model, visual = pretrain.build_models(pre_cfgs, dev, seed=0)
    n_model = sum(p_.numel() for p_ in model.parameters()) / 1e6
    n_visual = sum(p_.numel() for p_ in visual.parameters()) / 1e6
    reset(*kernel_fns)
    held = torch.cuda.memory_allocated(dev) / 2**30  # the two models and what earlier phases hold
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre_state = pretrain.train(pre_cfgs, pre_batches, model, visual, max_steps=pre_steps,
                               log_every=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = by_path["pretrain"] = counts(*kernel_fns)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rows = pre_state.history
    step_s = statistics.median(r_["seconds"] for r_ in rows[1:])
    log(f"[pretrain] {card}: LabelEncoderPretrain ({n_model:.1f} M parameters: max_len "
        f"{pre_mp['max_len']}, emb {emb}, {pre_mp['n_heads']} heads, {pre_mp['n_trans_layers']} "
        f"layers, clip 1024; fp32, AdamW with weight decay 1e-4) against a frozen ViTSTR "
        f"({n_visual:.1f} M), batch {pre_b} of synthetic {label_shape['size']}² label images, "
        f"{len(rows)} steps in {run_s:.2f} s in a world-size-"
        f"{torch.distributed.get_world_size()} {torch.distributed.get_backend()} group: s per step "
        f"{[round(r_['seconds'], 4) for r_ in rows]}, median after the first {step_s:.4f} "
        f"({pre_b / step_s:.1f} samples/s); loss "
        f"{[round(r_['loss/full_loss'], 4) for r_ in rows]}; clip_acc "
        f"{[round(r_['acc/clip_acc'], 4) for r_ in rows]}; peak device memory {peak:.2f} GiB "
        f"({held:.2f} GiB allocated before the steps); launches {launches}")
    if launches != expected():
        fail(f"pretraining launched a kernel: {launches}")
    if len(rows) != pre_steps or not all(np.isfinite(r_[k_]) for r_ in rows for k_ in r_):
        fail(f"pretraining: {len(rows)} steps logged, or a value not finite: {rows}")
    del pre_state, pre_batches
    fixed = SyntheticLabelBatches(1, 32, seed=16, **label_shape).batches[0]
    overfit = pretrain.train(pre_cfgs, [fixed], model, visual, max_steps=20, log_every=1).history
    losses = [r_["loss/full_loss"] for r_ in overfit]
    log(f"[pretrain] {card}: 20 steps on one fixed batch of 32: loss {losses[0]:.4f} → "
        f"{losses[-1]:.4f} (min {min(losses):.4f}), clip_acc {overfit[0]['acc/clip_acc']:.4f} "
        f"→ {overfit[-1]['acc/clip_acc']:.4f}, median s per step "
        f"{statistics.median(r_['seconds'] for r_ in overfit[1:]):.4f}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"pretraining does not fit one fixed batch: loss {losses}")

    # 15c. the gathered loss: under the world-size-1 NCCL group, the loss of
    # the all-gathered features and its gradients equal the plain ones
    images = torch.as_tensor(fixed["image"][:16]).to(dev)
    ids = torch.as_tensor(fixed["label_ids"][:16]).to(dev)
    with torch.no_grad():
        vis_emb = visual(images)
    gathered = {}
    for how in ("plain", "gathered"):
        model.zero_grad(set_to_none=True)
        out = model(ids, vis_emb)
        t_, v_ = out["text_out"], out["visual_out"]
        if how == "gathered":
            t_, v_ = all_gather_rows(t_), all_gather_rows(v_)
        loss, _ = clip_contrastive_loss(t_, v_, out["logit_scale"], out["cls_out"],
                                        out["pos_out"], ids)
        loss.backward()
        gathered[how] = (loss.detach(), [p_.grad.clone() for p_ in model.parameters()])
    same = bool(torch.equal(gathered["plain"][0], gathered["gathered"][0])) and all(
        torch.equal(a_, b_) for a_, b_ in zip(gathered["plain"][1], gathered["gathered"][1]))
    log(f"[pretrain] the gathered contrastive loss in the world-size-"
        f"{torch.distributed.get_world_size()} {torch.distributed.get_backend()} group: "
        f"{float(gathered['gathered'][0]):.6f} against the plain {float(gathered['plain'][0]):.6f}, "
        f"loss and every gradient bit-equal: {same}")
    if not same:
        fail("the all-gathered contrastive loss differs from the plain one on one process")
    del gathered, out, t_, v_, loss
    model.zero_grad(set_to_none=True)
    torch.distributed.destroy_process_group()
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        os.environ.pop(k)
    torch.cuda.empty_cache()

    # 15b. one pretraining step on the card against the same step on the CPU
    # from the same weights (phase 15a's seeded start) on the first 16 rows of
    # its first batch
    del model, visual
    torch.cuda.empty_cache()
    model, visual = pretrain.build_models(pre_cfgs, dev, seed=0)
    cpu_model, cpu_visual = copy.deepcopy(model).cpu(), copy.deepcopy(visual).cpu()
    first = SyntheticLabelBatches(1, 16, seed=15, **label_shape).batches[0]
    lr = float(pre_mp["lr"])
    steps, relu_in = {}, {}
    for where, m_, v_ in (("cuda", model, visual), ("cpu", cpu_model, cpu_visual)):
        dv = next(m_.parameters()).device
        hooks = [layer_.linear1.register_forward_hook(
            lambda mod_, in_, out_, i_=i_, w_=where: relu_in.__setitem__((w_, i_), out_.detach()))
            for i_, layer_ in enumerate(m_.encoder.encoder.layers)]
        t0 = time.perf_counter()
        step = pretrain.make_pretrain_step(m_, v_, pretrain.make_optimizer(m_, lr))
        loss, parts = step(torch.as_tensor(first["image"]).to(dv),
                           torch.as_tensor(first["label_ids"]).to(dv))
        steps[where] = (float(loss), {k_: float(v_) for k_, v_ in parts.items()},
                        time.perf_counter() - t0)
        for h_ in hooks:
            h_.remove()
    # feed-forward ReLU inputs whose sign the two sides round differently: each
    # passes its gradient on one side only, and one such unit of 12 × 2048 a
    # token moves the gradient's relative L2 by ≈ 1e-3 (PERF.md §6)
    flips = sum(int(((relu_in[("cuda", i_)].cpu() > 0) != (relu_in[("cpu", i_)] > 0)).sum())
                for i_ in range(len(model.encoder.encoder.layers)))
    del relu_in
    # the gradients over every parameter; the updates elementwise, given each
    # side's gradient: Adam's first step moves an element by lr·g/(|g| + 1e-8)
    # (and the decay), so where the gradient is at the two sides' rounding
    # level its direction is theirs to decide, and the two updates may differ
    # by up to 2·lr·|Δg|/|g| (at most 2·lr); beyond that, 1e-6 for the rounding
    # of the parameter itself
    g_diff = g_norm = 0.0
    beyond = excess = 0
    for p_gpu, p_cpu in zip(model.parameters(), cpu_model.parameters()):
        g_gpu, g_cpu = p_gpu.grad.detach().cpu().double(), p_cpu.grad.detach().double()
        g_diff += float((g_gpu - g_cpu).square().sum())
        g_norm += float(g_cpu.square().sum())
        d_ = (p_gpu.detach().cpu().double() - p_cpu.detach().double()).abs()
        decided = 2 * lr * torch.clamp((g_gpu - g_cpu).abs() / g_cpu.abs().clamp_min(1e-8), max=1)
        beyond += int((d_ > 1e-6).sum())
        excess += int((d_ > 1e-6 + decided).sum())
    grad_err = (g_diff / g_norm) ** 0.5
    n_el = sum(p_.numel() for p_ in cpu_model.parameters())
    loss_err = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])
    part_err = max(abs(steps["cuda"][1][k_] - v_) for k_, v_ in steps["cpu"][1].items())
    log(f"[pretrain] one step at batch 16 from the seeded start, card against CPU (fp32 "
        f"throughout: TF32 matmul is off by default and the patch embedding is a matmul, not a "
        f"cuDNN conv): loss {steps['cuda'][0]:.6f} / {steps['cpu'][0]:.6f}, relative error "
        f"{loss_err:.2e} (tolerance 1e-4), the entries' max error {part_err:.2e} (1e-4); "
        f"gradients' relative L2 over all {n_el} parameters {grad_err:.2e} (tolerance 1e-2: "
        f"{flips} feed-forward ReLU inputs change sign between the two); "
        f"updated parameters: {beyond} elements differ by more than 1e-6 (Adam's direction "
        f"taken from gradients at the rounding level), {excess} by more than their gradients' "
        f"disagreement allows (tolerance 0); CPU step {steps['cpu'][2]:.2f} s")
    if loss_err > 1e-4 or part_err > 1e-4 or grad_err > 1e-2 or excess:
        fail("pretraining step: card and CPU disagree")
    del model, visual, cpu_model, cpu_visual, step
    torch.cuda.empty_cache()

    # 15d. the metrics: FIDInceptionV3's pool3 features and LPIPSAlex's
    # distances of 8 synthetic 512² image pairs on the card against the CPU,
    # through the metrics module's loaders reading weight files of seeded
    # random weights; images/s of each at 512² (the eval CLI's quan_test ran in
    # phase 12)
    rs_m = np.random.RandomState(17)
    yy, xx = np.mgrid[0:512, 0:512].astype(np.float32) / 512
    pics = np.stack([np.clip(0.5 + 0.4 * np.sin(np.stack([xx * f_[0], yy * f_[1],
                                                          (xx + yy) * f_[2]], -1) * 6)
                             + 0.05 * rs_m.standard_normal((512, 512, 3)), 0, 1)
                     for f_ in rs_m.uniform(1, 4, (16, 3))]).astype(np.float32)
    fake, real = pics[:8], pics[8:]
    with tempfile.TemporaryDirectory(prefix="udt_metrics_") as work:
        files = write_metric_weights(work, seed=1)
        fns = {}
        for where in ("cpu", dev):
            fns[str(where)] = (
                metrics.load_inception_feature_fn(files["UDIFFTEXT_FID_WEIGHTS"], device=where),
                metrics.load_lpips_distance_fn(files["UDIFFTEXT_LPIPS_WEIGHTS"],
                                               files["UDIFFTEXT_ALEXNET_WEIGHTS"], device=where))
    feats_cpu = fns["cpu"][0](fake)
    dists_cpu = np.array([fns["cpu"][1](a_, b_) for a_, b_ in zip(fake, real)])
    feature_fn, distance_fn = fns[str(dev)]
    reset(*kernel_fns)
    feats = feature_fn(fake)
    dists = np.array([distance_fn(a_, b_) for a_, b_ in zip(fake, real)])
    fid_s, lpips_s = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        feature_fn(real)
        fid_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for a_, b_ in zip(fake, real):
            distance_fn(a_, b_)
        lpips_s.append(time.perf_counter() - t0)
    launches = by_path["metrics"] = counts(*kernel_fns)
    feat_err = rel_l2(torch.from_numpy(feats), torch.from_numpy(feats_cpu))
    spread = float(np.abs(feats_cpu - feats_cpu.mean(0)).max() / np.abs(feats_cpu).max())
    dist_err = float(np.max(np.abs(dists - dists_cpu) / np.abs(dists_cpu)))
    fid_ms, lpips_ms = statistics.median(fid_s), statistics.median(lpips_s)
    log(f"[metrics] {card}: pool3 features of 8 images (512² → 299²), card against CPU: "
        f"relative L2 {feat_err:.2e} (tolerance 1e-2: cuDNN convolutions take TF32 by "
        f"PyTorch's default, as pytorch_fid's run does; the features' spread across images "
        f"{spread:.3f} of their largest value); LPIPS of 8 pairs at 512²: "
        f"{[round(float(d_), 5) for d_ in dists]}, max relative error {dist_err:.2e} "
        f"(tolerance 1e-2); FID extractor {8 / fid_ms:.1f} images/s (batches of 8, median of "
        f"5: {fid_ms * 1e3:.1f} ms a batch, host to host); LPIPS {8 / lpips_ms:.1f} pairs/s "
        f"({16 / lpips_ms:.1f} images/s, one pair a call as calc_lpips calls it); "
        f"launches {launches}")
    if launches != expected():
        fail(f"the metrics launched a kernel: {launches}")
    if (feats.shape != (8, 2048) or not np.isfinite(feats).all() or feat_err > 1e-2
            or spread < 1e-3 or not np.isfinite(dists).all() or dist_err > 1e-2):
        fail(f"metrics: features {feats.shape}, relative L2 {feat_err}, distances {dists}")
    del fns, feature_fn, distance_fn
    torch.cuda.empty_cache()

    # 16. the conditioning surface: the option graph's demo flow, two
    # fine-tuning steps with trainable embedders, the OpenCLIP towers, and
    # encoder propagation refusing the ctrl block
    conditioning_options(dev, card, kernel_fns, expected, by_path, demo_s, ab_tol)

    # 17. the VAE's adversarial training steps; 18. the STR hub (no kernel on
    # either path)
    gan_s = vae_gan(dev, card, kernel_fns, expected, by_path)
    str_s = str_hub_phase(dev, card, kernel_fns, expected, by_path)
    # 19. the STR data path, tools and trainer (no kernel on the path)
    data_s = str_data_phase(dev, card, kernel_fns, expected, by_path)
    log(f"[phases] 17 (VAE GAN) {gan_s:.1f} s, 18 (STR hub) {str_s:.1f} s, 19 (STR data, "
        f"tools, trainer) {data_s:.1f} s")
    if data_s > 60:
        fail(f"phase 19 took {data_s:.1f} s (limit 60)")

    # 20-21. the multi-card paths: the dp-2 service and the tensor-parallel
    # step, each on two ranks against one process
    multi_s = multicard_phases(dev, card, kernel_fns, expected, by_path)
    log(f"[phases] 20-21 (dp serving, tensor-parallel step) {multi_s:.1f} s")

    # 22. the stage and floor probes
    probes_s = probes_phase(dev, card, kernel_fns, expected, by_path)
    log(f"[phases] 22 (probes) {probes_s:.1f} s")
    if probes_s > PROBE_LIMIT_S:
        fail(f"phase 22 took {probes_s:.1f} s (limit {PROBE_LIMIT_S})")

    kernels = []
    for name, src, replaces, key, path in (
        ("flash_attention_fwd", "udifftext_tpu_torch/csrc/flash_attention.cu",
         "udifftext_tpu/ops/flash_attention.py:41", "flash_attention", "train"),
        ("flash_attention_bwd", "udifftext_tpu_torch/csrc/flash_attention_bwd.cu",
         "udifftext_tpu/ops/flash_attention.py:181", "flash_attention_bwd", "train"),
        ("geglu_ff", "udifftext_tpu_torch/csrc/geglu.cu", "udifftext_tpu/ops/geglu.py:105",
         "geglu_ff", "train"),
        ("ln_gemm", "udifftext_tpu_torch/csrc/ln_gemm.cu", "udifftext_tpu/ops/ln_gemm.py:35",
         "ln_gemm", "glue_probe"),
        ("ln_gemm3", "udifftext_tpu_torch/csrc/ln_gemm.cu", "udifftext_tpu/ops/ln_gemm.py:149",
         "ln_gemm3", "glue_probe"),
        ("fused_cross_attention", "udifftext_tpu_torch/csrc/cross_attention.cu",
         "udifftext_tpu/ops/cross_attention.py:36", "fused_cross_attention", "glue_probe"),
        ("geglu_ff_ln", "udifftext_tpu_torch/csrc/geglu.cu", "udifftext_tpu/ops/geglu.py:55",
         "geglu_ff_ln", "glue_probe"),
        ("fused_groupnorm_silu", "udifftext_tpu_torch/csrc/groupnorm.cu",
         "udifftext_tpu/ops/groupnorm.py:36", "fused_groupnorm_silu", "resblock_probe"),
        ("flash_variant_v1", "udifftext_tpu_torch/csrc/flash_variants.cu",
         "udifftext_tpu/ops/flash_attention.py:41", "flash_variant_v1", "flash_variants"),
        ("flash_variant_v2", "udifftext_tpu_torch/csrc/flash_variants.cu",
         "scripts/flash_variants.py:37", "flash_variant_v2", "flash_variants"),
        ("flash_variant_v3", "udifftext_tpu_torch/csrc/flash_variants.cu",
         "scripts/flash_variants.py:76", "flash_variant_v3", "flash_variants"),
        ("flash_variant_v4", "udifftext_tpu_torch/csrc/flash_variants.cu",
         "scripts/flash_variants.py:37", "flash_variant_v4", "flash_variants"),
    ):
        if by_path[path][key] < 1:
            fail(f"{name} was launched no time on the {path} path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": by_path[path][key], "launches_path": path, **records[key],
                        "launches_by_path": {p_: c_[key] for p_, c_ in by_path.items()}})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multicard-rank"]:
        multicard_child(sys.argv[2])
    else:
        main()
