"""Chip smoke for the PyTorch/CUDA port (``pytorch_distributed_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (an H100):

    python3 chip_smoke.py                  # everything
    python3 chip_smoke.py --kernels-only   # (a) and (b), then stop
    python3 chip_smoke.py --parallel-only  # (a) for flash and the tail, then the
                                           # FSDP and pipeline ranks (no recipes)
    python3 chip_smoke.py --tp-only        # (a) for flash, then the tensor-parallel
                                           # phase (with its recipes)

With 2-4 cards (a ``--chips 4`` machine) the same script runs the ring
and the data-parallel phases a rank a card over NCCL and times the DP
step at 1, 2 and 4 cards.

Phases, each of which fails the run:

  (a) the card's name and power limit; the CUDA kernels build from
      ``pytorch_distributed_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, one
      nvcc per source, all started together; the native record reader
      (``csrc/recordio.cpp``, host code) with g++;
  (b) each kernel against the plain PyTorch version on the card: the paged
      kernels at the full-width serving shapes and at small GQA /
      padding-row shapes, one with R = G·C = 80 rows per KV head (two
      row tiles of the bf16 sweep's tensor-core kernel), the bf16 split
      (``paged_split_tc_kernel``) at every check that splits (decode, q a
      strided view, GQA R = 20 and R = 80 with S = 3, D = 128) and at a
      forced S = 16, each split also bitwise over two launches; the
      int8 / fp8 e4m3 / fp8 e5m2 pools at the decode shape and on a 32-row
      chunk with bf16 q (the tensor-core kernels: codes widened in the
      products, scales outside them) and fp32 q (the CUDA-core walk), and
      with bf16 q at the bf16 route's other shapes (GQA R = 20 and R = 80
      with padding and fully masked rows, D = 128), each split bitwise over
      two launches; the quantize-on-scatter kernel
      bit-equal, in the three pool dtypes, at a chunk shape (8 jobs x 32
      rows) and the decode shape (8 rows), rows whose amax spans 1e-8 to
      1e4; the same rows written on the append route
      (``paged_quantize_scatter_attention``, bf16 q: the tensor-core sweep
      or split quantizes and stores them before it reads them, one launch)
      in the three pool dtypes at the decode shape with an inactive lane,
      the prefill chunk, D = 128 and GQA R = 80 with padding rows, split_s
      1, 2 and auto: pools and scales bit-equal to the plain scatter's, the
      output bit-equal to the two-launch route's (kernel 9, then the same
      kernel) and near the plain version's, two launches bitwise equal;
      the flash forward (O, LSE) and fused backward (dQ, dK, dV) at
      the training shape in bf16, at ragged lengths in fp32 (causal and
      not), at D = 128, and with fully masked rows; the split backward (dK/dV and dQ kernels, both TMA +
      wgmma in bf16) at the same shapes and at the ring's (a 1024-row
      shard; 512-row zigzag chunk views with the shard's LSE and a
      sliced, precomputed Δ) against the plain version and against the
      fused kernel (dK, dV bitwise equal);
      the bottleneck tail's moments, tail_bwd_reduce (gp bit-equal) and
      tail_bwd_dz at ResNet-50's four stage shapes (B = 128, bf16), moments
      at the four downsample inputs, the stage shapes at B = 8 in fp32,
      the stage shapes and downsample inputs at each batch the DP phase
      runs them at (B = 32 in bf16 and fp32, and the concatenated batch of
      its ranks in fp32), and ragged shapes (N = 147, F = 40); two launches bitwise equal for
      moments, tail_bwd_reduce, tail_bwd_dz and both flash backwards at
      every shape they are checked at; all three also on rows 16 bytes wider
      than their channels (z; out for tail_bwd_reduce, gp for tail_bwd_dz):
      the bf16 kernels (``tail_reduce_wgmma_kernel``,
      ``tail_dz_wgmma_kernel``) read them through tensor maps;
  (c) the port's main paths, each with the launch counters reset just
      before and read just after, on the full-width LM (32000 vocab, 12
      layers, 12 heads, width 768, 2048 positions, bf16, random weights
      from seed 0): ``Scheduler`` serves 16 requests, then the final prefill
      logits of the kernel path against a plain-attention run; the same 16
      requests on int8, fp8 and fp8_e5m2 pools of the bf16 pool's bytes
      (more blocks), with their greedy match against the bf16 serve, each
      serve's sweep and split launches all on the tensor-core route and
      all on the append route (every quantized serve: standalone kernel 9
      launches no time); a
      prefix-sharing serve (16 requests on a 512-token shared prefix,
      staggered) against prefix off; an over-committed fp8 serve that
      preempts on OOM, by swap and by recompute, against the ample one;
      the request lifecycle (``lifecycle_runs``): the warmed-up bf16 graph
      serve by ``step()`` and by the lagged loop (``collect_tick();
      dispatch_tick()``), streams and launches bit-equal, tick, tok/s,
      TTFT and busy share side by side; the swap pressure serve by the
      lagged loop, and under a fault raised once at each ``kv.*`` site
      (every site fires, >= 3 swap aborts, the fault-free streams); cancels
      in every state and deadlines at fixed ticks by both loops, survivors
      bit-equal, nothing left behind; ``drain_graceful`` and ``abandon``;
      ``ContinuousBatcher`` dense against paged (logits, greedy match, tick
      p50), ``generate_ragged`` against ``generate``, and ``serve_lm
      --dense`` run to its end; the serving fleet (``fleet_runs``, in a
      spawned process of its own, ``fleet_phase``): one replica and two
      mixed ones on the card, sharing its weights, by the synchronous and
      the lagged loop in turns (streams, placement and decisions
      bit-equal, step and tick p50, tok/s, TTFT, busy by CUDA events and
      profiled (``graph_runs``' ``busy_shares``), host syncs a step:
      none), disaggregated 1 +
      1 with every handoff byte-equal on bf16 and fp8 pools, a seeded
      64-request trace that spills and sheds (each loop's decisions its
      CPU twin's), a replica killed mid-serve and revived (no capture by
      the survivor), a hang past the tick deadline, a fault at each
      handoff site, the HTTP/SSE gateway (streams equal to the in-process
      fleet's, 429, a disconnect's cancel), and ``serve_lm --replicas 2
      --disaggregate --async-host`` and ``--http-port 0`` run to their
      end; the kernels line also counts kernels 7-9 in this phase
      (``fleet_launches``);
      ``LMTrainer`` takes 8 steps at batch 8 x 2048 tokens and one
      validation pass, then the first step's loss and grad norm with flash
      attention against dense attention (batch 2); ResNet-50 (random weights
      from seed 0, synthetic 224^2 images): the fused-bottleneck bf16
      ``Trainer`` takes 8 steps at B = 128 and a validation pass, with 20 /
      16 / 16 tail launches a step, then the first step's loss and grad
      norm of the fused model against the plain-block one from the same
      weights (B = 64, fp32 and bf16), then ``recipes/resnet_single.py``
      (fp32, plain blocks: no tail launch) for 4 steps of B = 64; the
      input pipeline (``data_runs``, in a spawned process of its own,
      ``in_child``): raw splits of seeded 256^2 uint8
      images packed without PIL (2048 train and 256 val records), each
      opened with the native reader; the loader's img/s for the random
      crop on the native whole-batch path and the per-sample path at 0 and
      8 threads, the validation center crop, the JPEG split and ``rrc``
      where PIL imports, an epoch with each batch copied to the card and
      one batch's copy (uint8 and float32), the first native batch
      bit-equal to the per-sample one; the fused bf16 ``Trainer`` for 16
      steps of B = 128 from the raw split (8 loader threads, 2 batches
      ahead) and a validation pass, 20 / 16 / 16 tail launches a step and
      none in validation, every batch from the native crop, no loader
      thread left, its step p50 beside the synthetic run's; then
      ``recipes/resnet_single.py`` and ``recipes/resnet_ddp.py`` with
      ``--raw --raw-aug crop`` (a rank a card over NCCL with 2-4 cards);
      data parallelism, spawned by ``tools/dp_check.py`` on the ring's ranks (2
      gloo ranks sharing one card, the all-reduces staged through the host,
      or a rank a card over NCCL with 2-4 cards): 3 DP steps of B = 32 a
      rank of the fused bf16 and the plain fp32 ResNet-50 against a
      one-process emulation on the card (each replica's rows in turn,
      gradients and BatchNorm statistics averaged), with 20 / 16 / 16 tail
      launches a step on each rank of the fused one; sync-BN (fused and
      plain, fp32) against one rank on the concatenated batch; the fp16
      scaler (fp32 compute) with an inf on rank 1, every rank skipping the
      update and halving the scale; ``recipes/resnet_dp.py``,
      ``resnet_ddp.py`` and ``resnet_ddp_amp.py`` for 2 steps (a world of
      one on one card, a rank a card on more); with 2-4 cards the fused
      bf16 (B = 128 a card) and plain fp32 (B = 64) step p50, img/s and
      scaling at 1, 2 and 4 cards over NCCL and back, with each rank's busy
      share and its device time a step in NCCL kernels and the rest;
      suspend, resume, fallback and rollback (``resume_runs``, cuDNN on its
      deterministic algorithms): the fused bf16 ResNet-50 ``Trainer``, 6
      steps of B = 128, run twice uninterrupted (the card's own repeat
      difference), suspended before step 3 and resumed by a fresh trainer
      (20 / 16 / 16 tail launches a resumed step), with interval saves every
      2 steps and the newest one truncated (the resume falls back to the
      one before), and with NaN batches at steps 2 and 3, ``nan_guard`` and
      ``max_bad_steps`` 2 (one rollback, against the same run skipping
      only); the full-width LM, 4 steps of B = 8 x 2048, twice, and
      suspended at step 2 and resumed (12 flash forward and 12 fused
      backward launches a resumed step); the ranks of the ring phase
      (``tools/resume_check.py``, B = 32 a rank) with SIGUSR1 to rank 1
      alone: every rank saves at the same step and exits 0, and a resume
      on the same ranks; each resumed state bitwise equal to the
      uninterrupted run where two uninterrupted runs are, else within twice
      their difference; the save's stages and the restore timed, in ms and
      GB/s, beside the card's name and power limit; the ring,
      spawned by ``tools/ring_check.py``: on one card 2 ranks over gloo
      with the P2P traffic staged through the host (a correctness run, not
      a speed run), with 2 or more cards one rank a card, up to 4, over
      NCCL: ``ring_flash_attention`` at B = 8, L = 2048, contiguous and
      zigzag, fused and split backward, gathered and held against
      single-card flash (relative error), with each rank's launches;
      ``LMTrainer`` at dp 1 x sp ranks with ``ring_flash``, 2 steps of
      B = 8 x 2048 and a validation pass in each layout, the first step
      against the one-card flash step; ZeRO-3 FSDP and the GPipe pipeline
      (``parallel_runs``, the ranks spawned once by ``tools/parallel_check.py``
      on the ring's ranks): the full-width LM under FSDP and replicated DP
      for 2 steps at a global B = 8 x 2048 and a validation batch (relative
      error by step and of the validation loss; FSDP's first step against
      the one-card step), the pipeline with a stage a rank, 8 microbatches
      of B = 8, 2 steps and a validation batch against
      ``make_pp_reference_step`` and the plain eval step on one card, every
      stage's embedding and head bit-equal, ResNet-50's fused bf16
      ``Trainer(fsdp=True)`` against the replicated trainer at lr 1e-3 (2
      steps of B = 32 a rank and a validation batch), each rank's flash
      (12 + 12 a step under FSDP, (12/S)·8 a stage) and tail (20 / 16 /
      16) launches, parameter + optimizer bytes (FSDP at most 0.55 of
      replicated), peak memory, step p50 and a profiled step's busy share;
      ``lm_pretrain --fsdp`` run to its end, and ``--pipeline-stages 2``
      (refused on one card), the whole phase in a spawned process of its
      own (``in_child``); the kernels line adds these launches
      (``parallel_launches``); Megatron tensor parallelism (``tp_runs``, in
      a process of its own, the ranks spawned once by
      ``tools/parallel_check.py``): on one card 2 ranks over gloo, every
      tp_copy / tp_reduce staged through the host, the full-width LM at
      T 2 with MHA, with vocab parallelism and with GQA + RoPE, 3 steps of
      B 4 x 2048 and a validation batch, each step's loss and grad norm,
      every parameter gathered to its global leaf (its update) and the
      validation loss against the one-card step from the same weights, 12 +
      12 flash launches a step on each rank at H 6, a rank's parameter and
      optimizer bytes against the predicted share, ``lm_pretrain
      --model-parallel 2`` refused; on 4 cards over NCCL T 2 x DP 2 (also
      vocab-parallel and with FSDP), T 4 (also vocab-parallel) and
      replicated DP 4 against the one-card step, step p50 against DP 4's,
      the state shares, and the recipe with ``--model-parallel 2``, ``4``
      and ``2 --fsdp`` against its one-card run; then kernels 4 and 5 at
      the TP shapes (B 8, L 2048, H 6 and H 3, q/k/v strided views of one
      fused projection) against their plain versions and timed beside
      SDPA and the bound; the kernels line adds these launches
      (``tp_launches``) and times (``tp``);
  (d) kernel, plain-version and library times beside each kernel's bound
      (the flash calls also by their kernels' device time):
      the paged kernels at the decode shape (library: SDPA on pre-gathered
      K/V; no PyTorch call reads int8/fp8 K/V with per-row scales, so the
      quantized variants and the scatter have none, and the quantized
      variants give the spelling's time instead: gather, dequantize, SDPA;
      the splits and the quantized sweeps also by their kernel's device
      time), the sweeps also at the prefill chunk where the serve runs them
      (B 4 x C 32, W 64), the
      scatter at the chunk and decode shapes (also by device time), kernel
      9 on the append route (the split at decode, the sweep at the prefill
      chunk) beside the two-launch route and the kernel alone, by CUDA
      events and device time, the flash kernels at the training shape
      (library: causal SDPA, forward, and its backward through autograd),
      the tail kernels at ResNet-50's four stage shapes and moments also at
      the four downsample inputs, each also by its kernels' device time,
      beside the cuBLAS spelling of the XLA step (no single PyTorch call
      computes them, so they have no library time);
  (e) one JSON line listing every kernel;
  (f) the last line: ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or outside
the repository. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
import weakref

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# fp8 and int8 operands could run on the tensor cores at 1979 T/s
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12, "torch.int8": 1979e12,
              "torch.float8_e4m3fn": 1979e12, "torch.float8_e5m2": 1979e12}
QUANT = ("int8", "fp8", "fp8_e5m2")
BF16_TOL = 2e-2  # bf16 output, p rounded to bf16 before PV
FP32_TOL = 1e-4
SPLIT_VS_SWEEP_TOL = 1e-3  # another fp32 summation order (paged_flash.py:278)
# bf16 gradients of |g| <= 8: two bf16 ulps at 8; the kernels sum S, dP and
# dQ in another (fixed) order than the plain version, and round p and dS
# from those sums. At D = 128 the backward scales S in fp32 by the
# bf16-rounded scale where the plain version rounds q * scale to bf16 (a
# relative 2^-9 on S), well inside the same tolerance
BF16_GRAD_TOL = 6e-2
LSE_TOL = 1e-4  # fp32 statistics in another summation order
# flash vs dense training step, bf16 compute through 12 layers: flash
# rounds p to bf16 before PV and dS before dQ/dK, dense keeps fp32
# probabilities; the loss is a mean over 4094 tokens
TRAIN_LOSS_TOL = 2e-2
TRAIN_GRAD_NORM_RTOL = 5e-2
TRAIN = dict(batch=8, seq=2048, steps=8)
# the pressure tier: 200 fp8 blocks for the 16 requests (about 590 at once)
PRESSURE = dict(kv_dtype="fp8", n_blocks=200, offload=True, preempt_on_oom=True)
# the dense decode path's logits against the full causal forward (max_abs_err):
# the bf16 batchers as served (read at 0.047 dense, 0.055 paged on an H100),
# generate_ragged's steps in fp32 with TF32 off (read at 7.4e-6)
DECODE_TOL = {"bf16": 0.1, "fp32": 1e-3}
# the fleet phase's seeded trace (fleet.generate_trace, its first 64
# requests, clamped to 2048 positions) replayed at 0.1 s a tick under
# depth-only SLOs: on the serving geometry (8 slots a replica, blocks of
# 16, chunk 32) it spills and sheds
FLEET_TRACE = dict(seed=0, duration_s=60.0, base_rate=4.0, burst_rate_mult=6.0,
                   burst_every_s=5.0, burst_len_s=1.0, sessions=16, prompt_median=256,
                   prompt_sigma=0.8, max_new_median=16, max_new_sigma=0.5)
FLEET_TRACE_N = 64
FLEET_TICK_S = 0.1
FLEET_SLO = dict(spill_queue_depth=3, shed_queue_depth=8)
# the hang at a tick: past the tick deadline, which is far above a warmed
# tick's wall
FLEET_HANG = dict(tick_deadline_s=0.5, seconds=0.75)
# the fleet phase's recipe runs, each in a process of its own
FLEET_RECIPES = {"disaggregated": ["--replicas", "2", "--disaggregate", "--async-host"],
                 "gateway": ["--replicas", "2", "--http-port", "0", "--http-duration", "3"]}

# kernel 6, the split backward, against its plain version, the fused kernel
# and itself: (label, dtype, causal, shift, flash_inputs shape); a shape
# with ``view=(q half, kv half)`` checks a zigzag ring visit: the two halves
# of the shard as strided views, with the shard's O and LSE (its causal
# forward) and Δ computed once for the shard and sliced, as the ring passes them
SPLIT_CHECKS = (
    ("training shape B=8 L=2048 H=12 D=64 causal bf16", "bfloat16", True, 0, {}),
    ("training shape B=8 L=2048 H=12 D=64 full bf16", "bfloat16", False, 0, {}),
    ("ring shard B=8 L=1024 H=12 D=64 causal bf16", "bfloat16", True, 0, dict(l=1024, seed=5)),
    ("ring shard B=8 L=1024 H=12 D=64 full bf16", "bfloat16", False, 0, dict(l=1024, seed=5)),
    ("ring zigzag (hi, lo) chunk views of the L=1024 shard, sliced delta, bf16", "bfloat16",
     False, 0, dict(l=1024, seed=6, view=(1, 0))),
    ("ring zigzag (hi, hi) chunk views of the L=1024 shard, sliced delta, bf16", "bfloat16",
     True, 0, dict(l=1024, seed=6, view=(1, 1))),
    ("ragged L=300 fp32 causal", "float32", True, 0, dict(b=2, l=300, h=2, seed=1)),
    ("ragged L=300 fp32 full", "float32", False, 0, dict(b=2, l=300, h=2, seed=1)),
    ("Lq=90 Lk=200 fp32 full", "float32", False, 0, dict(b=2, l=90, lk=200, h=2, seed=2)),
    ("Lq=200 Lk=90 fp32 causal", "float32", True, 0, dict(b=2, l=200, lk=90, h=2, seed=2)),
    ("ragged L=300 bf16 causal", "bfloat16", True, 0, dict(b=2, l=300, h=2, seed=1)),
    ("Lq=90 Lk=200 bf16 full", "bfloat16", False, 0, dict(b=2, l=90, lk=200, h=2, seed=2)),
    ("Lq=200 Lk=90 bf16 causal", "bfloat16", True, 0, dict(b=2, l=200, lk=90, h=2, seed=2)),
    ("D=128 L=130 causal bf16", "bfloat16", True, 0, dict(b=2, l=130, h=2, d=128, seed=3)),
    ("D=128 L=130 causal fp32", "float32", True, 0, dict(b=2, l=130, h=2, d=128, seed=3)),
    ("rows 0-36 fully masked (shift -37) bf16", "bfloat16", True, -37,
     dict(b=1, l=100, h=2, seed=4)),
    ("rows 0-36 fully masked (shift -37) fp32", "float32", True, -37,
     dict(b=1, l=100, h=2, seed=4)),
)
# the ring: the training shape, 2 steps in each layout (4 until the TP
# serve's phase bought its time back), the full-width model
RING = dict(batch=8, seq=2048, steps=2, timeout_s=300)
RING_MODEL = dict(vocab_size=32000, num_layers=12, num_heads=12, embed_dim=768)
RING_CASES = [dict(impl="ring_flash", layout=layout, bwd_impl=bwd, causal=True)
              for layout in ("contiguous", "zigzag") for bwd in ("fused", "split")]


def ring_ranks(cards: int) -> tuple:
    """``(ranks, backend)`` of the ring phase: 2 ranks sharing one card (or
    the CPU) over gloo, else one rank a card, up to 4, over NCCL."""
    return (2, "gloo") if cards < 2 else (min(cards, 4), "nccl")


def ring_launches(layout: str, ranks: int) -> list:
    """Forward launches on each rank of one causal ring call: contiguous
    rank r folds the r + 1 shards at or before it; a zigzag rank runs
    three chunk kernels on its own shard and two on each other one."""
    if layout == "contiguous":
        return [r + 1 for r in range(ranks)]
    return [2 * ranks + 1] * ranks

# the ring's attention against single-card flash, bf16, each of O, dQ, dK,
# dV by ||ring - one card|| / ||one card||: the ring merges per-visit
# outputs in fp32 and rounds O once, and rounds each visit's gradients to
# bf16 before their fp32 sums; a few bf16 unit roundoffs (2^-9). A dropped
# or doubled visit moves a rank's rows by O(1)
RING_ATTN_RTOL = 1e-2
# the ring's first training step against the one-card flash step, bf16
# compute through 12 layers, the same rounding differences: measured
# (PERF.md) loss 9.1e-5 to 1.6e-4 and grad norm 5.2e-5 to 3.9e-4 relative
# on 1 and 4 cards; a few times those. Contiguous positions planted under
# zigzag moved them by 1.9e-2 and 9.6e-3 (a small model on the CPU)
RING_LOSS_TOL = 1e-3
RING_GRAD_NORM_RTOL = 2e-3
# the bottleneck tail kernels at ResNet-50's four stages, B = 128: (B, H = W,
# F) of the expand tail's z, E = 4F; and the downsample's strided input
TAIL_STAGES = ((128, 56, 64), (128, 28, 128), (128, 14, 256), (128, 7, 512))
TAIL_DOWNSAMPLE = ((128, 56, 64), (128, 28, 256), (128, 14, 512), (128, 7, 1024))
# fp32 sums (Σz, zᵀz, P, Σgp) relative to the largest |value|: blocks sum
# chunks of up to 3,072 rows, then the chunks in ascending order, over up
# to 401,408 rows; the plain version sums in cuBLAS's order
TAIL_SUM_RTOL = 1e-4
# dz relative to the largest |value|: bf16 output (one ulp 2^-8 relative)
# from fp32 sums in another order, and wa, c rounded to bf16 on both sides
TAIL_DZ_RTOL = {"torch.bfloat16": 8e-3, "torch.float32": 1e-4}
# fused vs plain-block ResNet-50, first step from the same weights. fp32:
# summation order only (tests/test_torch_resnet.py holds both to flax at
# 1e-5 / 1e-4). bf16: the two models round in different places (the
# tail's statistics from input moments, y3·a + b with a and b in bf16, on
# one side; the bf16 conv output normalized on the other), and at random
# weights the early BatchNorm grads of either bf16 model differ from fp32
# by O(1), so only the sums are compared, to bf16-noise tolerances
RESNET_FIRST_STEP_TOL = {"torch.float32": (1e-3, 5e-3), "torch.bfloat16": (0.2, 5e-2)}
RESNET = dict(batch=128, steps=8, compare_batch=64, recipe_batch=64, recipe_steps=4)
#: launches of (moments, tail_bwd_reduce, tail_bwd_dz) per ResNet-50 train
#: step: 16 expand tails plus 4 downsamples; 16; 16
RESNET_TAIL_LAUNCHES = (20, 16, 16)

# the data-parallel phase (PR 12): ResNet-50 (bench.py's model, its dtype and
# blocks set per case) at 224^2, B = 32 a rank, 3 steps at lr 0.1 from the
# seed-0 weights, on the ranks of ring_ranks
DP = dict(batch=32, steps=3, recipe_batch=32, recipe_steps=2, timeout_s=600)
DP_MODEL = dict(stage_sizes=(3, 4, 6, 3), block="bottleneck", num_classes=1000, num_filters=64)
DP_SIZE = 224
DP_SCHEDULE = (0.1, 1, 30, 0.1)  # step_lr: lr 0.1 throughout
DP_PLANT = (1, 1)  # the fp16 case: an inf in rank 1's rows at step 1
#: the ranks against their references on the same card, relative error of
#: each step's loss and grad norm, of the combined step-0 gradient, and of
#: the parameters and BatchNorm statistics after the first step and the
#: last (||ranks - reference|| / ||reference|| over all of them). Measured
#: on the H100 (2 gloo ranks on one card; 4 NCCL ranks on 4 cards, the
#: emulation on card 0). The card does not repeat fp32 ResNet-50's step-0
#: gradient bit for bit: the same input twice differs by 4.8e-6, in the
#: convolutions' weight gradients, the loss not at all
#: (tools/dp_sensitivity.py). Against the emulation, which runs the ranks'
#: shapes and kernels, step 0 differs by that and the gradients'
#: summation order: loss <= 6.5e-8, grad norm <= 1.6e-7, gradient 4.0e-6
#: (fp32; bf16 <= 8.2e-9), parameters <= 2.8e-7, statistics <= 4.1e-8.
#: Against the concatenated batch (cuDNN at 2-4x the batch, another
#: order): step 0 loss <= 5.2e-7, grad norm 1.6e-5 to 4.5e-4, statistics
#: <= 7.8e-7, gradient 2.5e-2 to 3.0e-2, because ResNet-50's step-0
#: gradient at random weights moves that much for rounding-level changes
#: (input noise of 1e-7 relative moved it by 2.3e-2 to 2.5e-2, of 1e-6 by
#: 3.5e-2), while per-replica statistics (a sum left out) move it 1.38-1.39:
#: the sync-BN check holds the gradient at 6e-2, 23x below that (checked
#: in the run). Its parameters after step 0 follow the gradient: SGD's
#: first step from the same p0 gives lr·||Δg|| / ||p1||, 1.3e-3 to 2.2e-3.
#: Later steps amplify what step 0 left at lr 0.1 (gradient norm 135-195
#: at step 0), bf16 most, where a parameter 1.6e-9 off re-rounds
#: activations: against the emulation at steps 1 and 2, fp32 loss <=
#: 2.8e-6 and 2.8e-3, grad norm <= 1.8e-4 and 5.9e-3; bf16 loss 1.3e-5 and
#: 3.9e-3, grad norm 1.4e-3 and 9.9e-3; against the concatenated batch
#: loss <= 4.0e-3 and 7.8e-3, grad norm <= 5.8e-3 and 5.0e-2; parameters
#: <= 2.8e-2 (emulation) and 6.4e-2 (concatenated) after 3 steps. The
#: tolerances are about 10x those (the gradient: 10x the card's own
#: repeat difference against the emulation). Step 0 is the tight check (a
#: summed rather than averaged gradient would double its grad norm)
DP_EMULATION_RTOL = {
    "float32": dict(loss=(1e-5, 1e-4, 3e-2), grad_norm=(1e-5, 2e-3, 5e-2), grad_first=5e-5,
                    params_first=1e-5, buffers_first=1e-5, params_last=0.2, buffers_last=0.1),
    "bfloat16": dict(loss=(1e-5, 2e-4, 4e-2), grad_norm=(1e-5, 2e-2, 0.1), grad_first=5e-5,
                     params_first=1e-5, buffers_first=1e-5, params_last=0.2, buffers_last=0.1)}
DP_SYNC_RTOL = dict(loss=(1e-5, 3e-2, 5e-2), grad_norm=(5e-3, 5e-2, 0.3), grad_first=6e-2,
                    buffers_first=1e-5, params_last=0.5, buffers_last=0.1)
#: the NCCL timing: a rank a card, B a card, ranks 1, 2, 4 (as many as there
#: are cards) and back, each rank profiled over ``profiled`` more steps
DP_TIMING = dict(fused=128, plain=64, warmup=3, steps=20, profiled=3)

# the FSDP and pipeline phase, on the ranks of ring_ranks: the
# full-width LM (RING_MODEL, 2048 positions, bf16, flash, grad clip 1.0,
# lr 3e-4) for 2 steps (3 until the TP serve's phase bought its time back),
# ZeRO-3 FSDP and replicated DP at a global batch of 8 (4 a rank on 2
# ranks), from the seed-0 weights; the pipeline at B 8 x 2048 in 8
# microbatches, a stage a rank, for 2 steps, and both on a validation
# batch; the fused bf16 ResNet-50 of the DP phase under FSDP and
# replicated at B 32 a rank for 2 steps and a validation batch; one more
# step of each LM run
# profiled for the card's busy share; then the recipe with --fsdp (and
# with --pipeline-stages 2 where 2 cards exist) for 2 steps
PARALLEL = dict(batch=8, seq=2048, steps=2, microbatches=8, profiled=1, recipe_steps=2,
                timeout_s=600)
#: the kernel sources the phase runs (``--parallel-only`` builds these)
PARALLEL_SOURCES = ("bottleneck_tail", "flash_attention")
PARALLEL_SCHEDULE = (3e-4, 1000, 0, 3e-4)  # warmup_cosine: lr 3e-4 throughout
#: FSDP against replicated DP on the same ranks and the pipeline against the
#: one-card sequential reference from the same stacked weights, relative
#: error of each step's loss and grad norm: the same function, its sums in
#: another order (a reduce-scatter for an all-reduce; the pipeline's
#: gradients accumulated a microbatch at a time, last first, where the
#: reference takes one backward of the summed loss), bf16 compute through
#: 12 layers; later steps carry AdamW's first moves of gradients that are
#: rounding noise (about lr each). The first step of FSDP also against the
#: one-card step at B 8: RING_LOSS_TOL and RING_GRAD_NORM_RTOL
PARALLEL_RTOL = dict(loss=(1e-3, 2e-3, 2e-3), grad_norm=(2e-3, 1e-2, 1e-2))
#: ResNet-50's Trainer(fsdp=True) against the replicated trainer: both at
#: lr RESNET_FSDP_LR, where a step's rounding does not grow. At the
#: Trainer's lr 0.1 these random-weight bf16 steps are chaotic (the DP
#: phase's fp32 run against its emulation reads 1.2e-6 at step 1 and
#: 6.5e-4 at step 2), and evaluation on three steps' running BatchNorm
#: statistics (losses in the hundreds) amplifies that again: over 4 NCCL
#: cards FSDP read 2.1e-4 / 1.7e-3 by step and 0.21 on the validation
#: loss against the replicated run, rounding and a fault alike (PERF.md).
#: At lr 1e-3 an update moves a weight by ~1e-3 of itself, so the
#: reduce-scatter's other summation order moves it by ~1e-10, which
#: rarely flips a bf16 rounding; a fault in the update (a wrong mean, a
#: part not written back) moves the loss by its share of a step's change,
#: which the phase prints beside the limits. Relative error of each
#: step's loss and of the validation loss
RESNET_FSDP_LR = 1e-3
RESNET_FSDP_RTOL = dict(loss=(1e-5, 1e-4, 1e-3), val=1e-3)
#: ZeRO-3 at 2 ranks: a rank's parameter and AdamW bytes against the
#: replicated rank's (the LayerNorm scales and biases stay whole)
FSDP_STATE_SHARE = 0.55

# the tensor-parallel phase (``tp_runs``): the full-width LM (RING_MODEL,
# 2048 positions, bf16, flash, grad clip 1.0, lr 3e-4, the seed-0 weights)
# under Megatron TP, against a one-card replicated reference from the same
# weights and global batches. On one card 2 ranks share it over gloo,
# every tp_copy / tp_reduce of a [B, L, E] activation (48 a step) staged
# through the host: T 2 with MHA, with vocab parallelism and with GQA +
# RoPE (TP_GQA), 3 steps of B 4 x 2048 (the training phase's B 8 cut to
# half for the staging's time) and a validation batch. On 4 cards over
# NCCL: T 2 x DP 2 (also vocab-parallel and with FSDP), T 4 (also
# vocab-parallel) and replicated DP 4, 3 steps of a global B 8, and the
# recipe with --model-parallel 2, 4 and 2 --fsdp (B 4 a replica, 2 steps'
# sequences) against its one-card run
TP = dict(batch=4, batch_4=8, seq=2048, steps=3, recipe_steps=2, recipe_batch=4,
          timeout_s=600)
TP_GQA = dict(num_kv_heads=4, pos_embedding="rope")
#: TP against the one-card step, relative error of each step's loss and
#: grad norm, and of the validation loss (the last step's loss limit);
#: and every leaf's update over the steps against the one-card one,
#: ||d_tp - d_one|| / ||d_one|| (the key bias's noise masked), its median
#: over the leaves and its worst leaf. Set from planted faults in the CPU
#: rehearsal (``tests/test_torch_chip_smoke_tp.py``'s sizes, bf16, in a
#: scratch copy) before any chip run: the true code read loss <= 1.5e-4,
#: grad norm <= 5.4e-4, updates median 0.05 / worst 0.13; tp_copy's
#: backward without its sum 2.8e-3 / 0.18-0.23 / 0.82 / 1.13; tp_reduce's
#: backward summing (a plain psum's transpose) 1.3e-3 / 4.0 / 0.53 / 0.79;
#: the fused CE's dx summed twice under vocab parallelism grad norm 0.93;
#: qkv cut into contiguous rows, not q/k/v sections, loss 2.6e-2 at step
#: 0, grad norm 8.2e-2, updates 1.22 / 1.38. bf16 through 12 layers rounds
#: more than the rehearsal's 2, so the limits sit 4-20x above the true
#: code's readings
TP_RTOL = dict(loss=(2e-3, 2e-3, 2e-3), grad_norm=(1e-2, 2e-2, 2e-2))
TP_UPDATE_RTOL = dict(median=0.25, worst=0.75)
#: a rank's parameter + AdamW bytes against one card's, beside the share
#: its parameter counts predict (``predicted_share``: at full width
#: 135.76 M parameters, 85.00 M in the blocks' matrices and biases, 49.15 M
#: in wte and lm_head, so 0.687 / 0.530 at T 2 / 4, 0.506 / 0.259
#: vocab-parallel); AdamW's step counts are the only other bytes
TP_SHARE_TOL = 1e-4
#: kernels 4 and 5 at the TP ranks' heads: H 12 / T at T 2 and T 4
TP_KERNEL_HEADS = (6, 3)
#: the kernel sources the phase runs (``--tp-only`` builds these)
TP_SOURCES = ("flash_attention", "paged_attention")
# the tensor-parallel serve (slice 22), cases of the TP phase's spawn on one
# card: its 2 gloo ranks at T 2, eager (the gloo group stages every
# tp_reduce through the host, which no CUDA graph holds), the full-width LM
# at 2048 positions in bf16, 8 slots, blocks of 16, chunk 32, 4 requests of
# 64-512 prompt tokens (requests 0 and 2 share their first 256 tokens, 16
# blocks; with the prefix cache each submit is followed by ``stagger``
# steps, so request 0's blocks are indexed before request 2 looks them up),
# 16 new tokens, greedy:
# (i) bf16 pools, (ii) fp8 pools (kernel 9's append route), (iii) GQA + RoPE
# (H_kv 4, 2 KV heads a rank) with the prefix cache, (iv) vocab-parallel;
# each against the one-card replicated Scheduler serve rank 0 runs after it
# from the same weights
TP_SERVE = dict(slots=8, block_len=16, chunk=32, lengths=(320, 64, 512, 200), prefix=256,
                stagger=9, max_new=16, max_seq_len=2048)
TP_SERVE_CASES = {"bf16": ({}, {}), "fp8": ({}, {"kv_dtype": "fp8"}),
                  "gqa_prefix": (TP_GQA, {"prefix_cache": True}),
                  "vocab": ({"vocab_parallel": True}, {})}
#: the TP serve's logits against the one-card serve's, max abs error: each
#: prompt's first-token row, and every decoded row while the two streams
#: agree. Set from planted faults in the CPU rehearsal
#: (``tests/test_torch_chip_smoke_serve_tp.py``'s sizes: 2 layers, 4 heads
#: of 32, bf16; in a scratch copy) before any chip run: the true code read
#: first rows <= 3.9e-2 and rows <= 3.9e-2 (fp8) in the four cases; rank 1
#: holding rank 0's K/V heads (its pool the wrong heads) 2.97-3.32 / 3.06-
#: 3.32, greedy match 0-0.08; proj's tp_reduce dropped 2.12-2.58 / 2.12-
#: 2.58 (and the ranks' streams apart but for vocab-parallel); rank 1's
#: clock skewed with no broadcast desynchronizes the ranks' collectives
#: (``tests/test_torch_serving_tp.py``'s deadline serve: the spawn dies).
#: Twelve bf16 layers round more than two, so the limits sit 6-13x above
#: the true code's readings and 4-8x below the faults'
TP_SERVE_TOL = dict(first=0.25, rows=0.5)
#: kernels 7 and 8 at the TP ranks' heads (``tp_paged_kernel_checks``):
#: H 6 and H 3 (MHA at T 2 and T 4), and GQA's H 6 over H_kv 2 (T 2)
TP_PAGED_HEADS = ((6, 6), (3, 3), (6, 2))

# the resume phase: the fused bf16 ResNet-50 (as bench.py builds it)
# at B = 128 for 6 steps, suspended at step 3 (the train.step fault site's
# suspend latches the watcher, as SIGTERM's handler does), interval saves
# every 2 steps, NaN batches at steps 2 and 3; the full-width LM at B = 8 x
# 2048 for 4 steps, suspended at step 2; the ranks of ring_ranks at B = 32 a
# rank for 3 steps (4 until the TP serve's phase bought its time back),
# SIGUSR1 to rank 1 alone before step 1. Every run from
# the seed-0 weights and the same synthetic data, its save_dir in a
# temporary directory
RESUME = dict(batch=128, steps=6, suspend_at=3, every=2, nan_at=2, size=224,
              lm_batch=8, lm_seq=2048, lm_steps=4, lm_suspend_at=2,
              dp_batch=32, dp_steps=3, dp_signal=1, timeout_s=600)
RESUME_RESNET = dict(DP_MODEL, dtype="bfloat16", fused=True)
RESUME_LM = dict(vocab_size=32000, num_layers=12, num_heads=12, embed_dim=768)

# the model-branches phase (slice 18): the JAX recipe's full-width LM with
# --kv-heads 4 --pos-embedding rope (H 12 over H_kv 4, G = 3, head_dim 64,
# rope_theta 10000), random weights from seed 0; its MoE variant (8
# experts in every second block, capacity 1.25, top-1 and top-2); dropout
# 0.1 runs of 6 steps (a suspend at step 4); the MoE runs 4 steps
BRANCH_MODEL = dict(num_kv_heads=4, pos_embedding="rope")
BRANCH = dict(dropout=0.1, dropout_steps=6, suspend_at=4, moe_experts=8, moe_steps=4)
BRANCH_RECIPE = ["--synthetic", "--kv-heads", "4", "--pos-embedding", "rope", "--dropout",
                 "0.1", "--steps", "3", "--log-every", "1"]
# the data phase: raw uint8 splits packed from seeded images at the
# stored size (no PIL), the loader's rates, bench.py's fused bf16 ResNet-50
# (DATA_MODEL) in Trainer fed from the records, then the recipes from raw splits
DATA = dict(train=2048, val=256, size=256, crop=224, batch=128, workers=8, prefetch=2,
            jpeg=256, recipe_batch=64, recipe_steps=4, dp_batch=32, dp_steps=3)
DATA_MODEL = dict(RESUME_RESNET)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def decode_inputs(torch, dtype, *, b=8, c=1, h=12, h_kv=12, d=64, bl=16, w=128,
                  seed=0, positions=None, dev="cuda"):
    """A full-size pool (every slot can hold 2048 positions, plus trash)
    filled with noise, trash included; ragged chains with trash tails."""
    rng = np.random.default_rng(seed)
    n_blocks = b * w + 1
    k_pool = torch.from_numpy(rng.standard_normal((n_blocks, bl, h_kv, d), np.float32))
    v_pool = torch.from_numpy(rng.standard_normal((n_blocks, bl, h_kv, d), np.float32))
    if positions is None:
        last = rng.integers(64, w * bl, size=b)
        last[0] = w * bl - 1
        positions = last[:, None] - c + 1 + np.arange(c)[None, :]
    positions = np.asarray(positions, np.int64)
    tables = np.zeros((b, w), np.int32)
    order = rng.permutation(np.arange(1, n_blocks))
    for i in range(b):
        n = int(positions[i].max()) // bl + 1 if positions[i].max() >= 0 else 0
        tables[i, :n] = order[i * w:i * w + n]
    q = torch.from_numpy(rng.standard_normal((b, c, h, d), np.float32))
    return dict(q=q.to(dev, dtype), k_pool=k_pool.to(dev, dtype),
                v_pool=v_pool.to(dev, dtype),
                block_tables=torch.from_numpy(tables).to(dev),
                q_positions=torch.from_numpy(positions).to(dev, torch.int32))


def prefill_inputs(torch, dtype, dev="cuda", seed=2, h_kv=12, h=12):
    """A prefill chunk as the serve runs the single sweep on it: 4 jobs x
    32 rows (the serve's prefill chunk) at chain starts 0, 32, 480 and 992,
    W = 64 blocks of 16; R = G·C = 32 rows per KV head (96 at ``h_kv`` 4,
    the GQA model's G = 3)."""
    starts = np.array([0, 32, 480, 992])
    return decode_inputs(torch, dtype, b=4, c=32, w=64, seed=seed, dev=dev, h=h, h_kv=h_kv,
                         positions=starts[:, None] + np.arange(32))


def gathered(torch, inp):
    """SDPA's operands for a paged call (its library yardstick): q ``[B, H,
    C, D]``, K and V gathered through the block tables into ``[B, H, W·bl,
    D]`` (a KV head repeated for its G query heads) and the position mask
    ``[B, 1, C, W·bl]``."""
    q, kp = inp["q"], inp["k_pool"]
    b, c, h, d = q.shape
    bl, h_kv = kp.shape[1], kp.shape[2]
    w = inp["block_tables"].shape[1]
    idx = inp["block_tables"].long()
    kg, vg = (pool[idx].reshape(b, w * bl, h_kv, d).repeat_interleave(h // h_kv, dim=2)
              .transpose(1, 2).contiguous() for pool in (kp, inp["v_pool"]))
    mask = (torch.arange(w * bl, device=q.device)[None, None, None, :]
            <= inp["q_positions"].long()[:, None, :, None])
    return q.transpose(1, 2).contiguous(), kg, vg, mask


def bound(inp) -> dict:
    """Least time for the work these inputs need: each visible K/V row
    (with its scale, on a quantized pool) read once, q, positions and
    tables read once, the output written once; QK and PV at 2 flops per
    multiply-add for each visible key, at the rate of the pools' type."""
    q, kp = inp["q"], inp["k_pool"]
    b, c, h, d = q.shape
    h_kv = kp.shape[2]
    elem = q.element_size()
    scale = inp["k_scale"].element_size() if inp.get("k_scale") is not None else 0
    pos = inp["q_positions"].cpu().numpy()
    visible_rows = int(np.maximum(pos.max(axis=1) + 1, 0).sum())  # per batch row
    n_bytes = (2 * visible_rows * h_kv * (d * kp.element_size() + scale)
               + 2 * q.numel() * elem
               + inp["q_positions"].numel() * 4 + inp["block_tables"].numel() * 4)
    flops = 4 * d * h * float(np.maximum(pos + 1, 0).sum())
    return roofline(n_bytes, flops, PEAK_FLOPS[str(kp.dtype)])


def roofline(n_bytes, flops, peak) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def quantized(torch, inp, kv):
    """``inp`` with its pools quantized to ``kv`` by the plain
    ``quantize_kv`` (scales beside them)."""
    from pytorch_distributed_tpu_torch.serving.kv_pool import kv_pool_dtype, quantize_kv

    kq, ks = quantize_kv(inp["k_pool"], kv_pool_dtype(kv))
    vq, vs = quantize_kv(inp["v_pool"], kv_pool_dtype(kv))
    return dict(inp, k_pool=kq, v_pool=vq, k_scale=ks, v_scale=vs)


def quant_spelling(torch, inp):
    """The quantized paged call spelled in PyTorch calls, its yardstick (no
    single PyTorch call reads int8/fp8 K/V with per-row scales): the codes
    and scales gathered through the tables, dequantized to q's dtype, each
    KV head repeated for its G query heads, then SDPA with the position
    mask. Returns the call."""
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.serving.kv_pool import scale_factors

    q, kp = inp["q"], inp["k_pool"]
    b, c, h, d = q.shape
    bl, h_kv = kp.shape[1], kp.shape[2]
    w = inp["block_tables"].shape[1]
    idx = inp["block_tables"].long()
    qt = q.transpose(1, 2)
    mask = (torch.arange(w * bl, device=q.device)[None, None, None, :]
            <= inp["q_positions"].long()[:, None, :, None])

    def call():
        kv = [(pool[idx].float() * scale_factors(sc)[idx][..., None]).to(q.dtype)
              .reshape(b, w * bl, h_kv, d).repeat_interleave(h // h_kv, dim=2).transpose(1, 2)
              for pool, sc in ((kp, inp["k_scale"]), (inp["v_pool"], inp["v_scale"]))]
        return F.scaled_dot_product_attention(qt, *kv, attn_mask=mask)
    return call


def scatter_inputs(torch, kv, dtype, *, b, l, h=12, d=64, bl=16, n_blocks=1025, seed=0):
    """Quantize-on-scatter operands on the card: k, v ``[B, L, H, D]`` as
    views of a fused ``[B, L, 3, H, D]`` qkv, each (row, head) scaled so
    amax spans 1e-8 to 1e4; destinations along ragged chains, the last
    batch row a dead lane writing the trash block; pools and scales of
    random bytes (so a stray write shows)."""
    from pytorch_distributed_tpu_torch.serving.kv_pool import kv_pool_dtype, pool_scale_dtype

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, 3, h, d))
    x *= np.exp(rng.uniform(np.log(1e-8), np.log(1e4), (b, l, 3, h, 1)))
    qkv = torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)
    w = -(-(l + 256) // bl)
    order = rng.permutation(np.arange(1, n_blocks))[:b * w].reshape(b, w)
    pos = rng.integers(0, 256, size=(b, 1)) + np.arange(l)[None, :]
    blk = np.take_along_axis(order, pos // bl, axis=1)
    off = pos % bl
    blk[-1], off[-1] = 0, 0  # a dead lane: every row onto trash (0, 0)
    pool_dt = kv_pool_dtype(kv)
    sc_dt = pool_scale_dtype(pool_dt)

    def noise(shape, dt):
        n = int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
        return torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).cuda().view(
            dt).reshape(shape)

    pools = [noise((n_blocks, bl, h, d), pool_dt) for _ in range(2)]
    scales = [noise((n_blocks, bl, h), sc_dt) for _ in range(2)]
    return (qkv[:, :, 1], qkv[:, :, 2], torch.from_numpy(blk).cuda(),
            torch.from_numpy(off).cuda(), *pools, *scales)


def scatter_bound(args) -> dict:
    """Each K/V row read once (input dtype), blk/off read once, each
    quantized row and its scale written once; a few fp32 operations per
    value (abs, max, scale, round)."""
    k, _, blk, _, kp, _, ks, _ = args
    rows = k.shape[0] * k.shape[1] * k.shape[2]
    n_bytes = (2 * rows * k.shape[3] * (k.element_size() + kp.element_size())
               + 2 * rows * ks.element_size() + 2 * blk.numel() * 8)
    return roofline(n_bytes, 2 * rows * k.shape[3] * 4, PEAK_FLOPS["torch.float32"])


def new_rows(torch, inp, seed=0):
    """A paged call's new K/V rows ``[B, C, H_kv, D]`` in q's dtype, as the
    model hands them to ``paged_quantize_scatter_attention``: views of a
    fused ``[B, C, 3, H_kv, D]`` projection, each (row, head) scaled so amax
    spans 1e-3 to 1e2."""
    rng = np.random.default_rng(seed)
    b, c, _, d = inp["q"].shape
    h_kv = inp["k_pool"].shape[2]
    x = rng.standard_normal((b, c, 3, h_kv, d))
    x *= np.exp(rng.uniform(np.log(1e-3), np.log(1e2), (b, c, 3, h_kv, 1)))
    qkv = torch.from_numpy(x.astype(np.float32)).to(inp["q"].device, inp["q"].dtype)
    return qkv[:, :, 1], qkv[:, :, 2]


def append_shapes(torch, dev="cuda"):
    """The append route's checks: (label, fp32 paged inputs) at the decode
    shape with its last lane inactive (a trash-only table row at position
    0, as the engine arms it), at the serve's prefill chunk, at D = 128
    with GQA (G 2), at GQA R = G·C = 80 rows (several row tiles write
    the same rows) with padding rows (-1) and a fully masked batch row, and
    at the GQA + RoPE model's G = 3 decode and prefill chunk."""
    decode = decode_inputs(torch, torch.float32, seed=12, dev=dev)
    decode["block_tables"][-1] = 0
    decode["q_positions"][-1] = 0
    pos = np.full((3, 20), -1)
    pos[0] = 180 + np.arange(20)
    pos[1, :7] = 40 + np.arange(7)
    return (
        ("decode B=8 C=1 H=12 D=64 W=128, the last lane inactive", decode),
        ("prefill chunk B=4 C=32 W=64", prefill_inputs(torch, torch.float32, dev=dev, seed=13)),
        ("D=128 H=4 H_kv=2 C=2", decode_inputs(torch, torch.float32, b=2, c=2, h=4, h_kv=2,
                                               d=128, w=8, seed=14, dev=dev)),
        ("GQA H=8 H_kv=2 C=20 (R=80) padding rows", decode_inputs(
            torch, torch.float32, b=3, c=20, h=8, h_kv=2, w=16, seed=15, positions=pos,
            dev=dev)),
        # the GQA + RoPE model's geometry (H 12 over H_kv 4): decode R = 3,
        # the prefill chunk R = 96
        ("GQA H=12 H_kv=4 decode (R=3)", decode_inputs(torch, torch.float32, h_kv=4, seed=17,
                                                       dev=dev)),
        ("GQA H=12 H_kv=4 prefill chunk (R=96)", prefill_inputs(torch, torch.float32, dev=dev,
                                                               seed=18, h_kv=4)),
    )


def check_append_route(torch, failures, dev="cuda") -> dict:
    """Kernel 9 on the append route: ``paged_quantize_scatter_attention``
    with bf16 q and rows on int8, fp8 and fp8_e5m2 pools (one launch of the
    tensor-core sweep or split that writes the new rows before it reads
    them) at ``append_shapes``, split_s 1, 2 and auto: its pools and scales
    bit-equal to the plain version's (the trash block aside, where the
    two-launch route puts padding rows), its output bit-equal to the
    two-launch route's (``scatter_then_attend``: kernel 9, then the same
    tensor-core kernel) and within ``BF16_TOL`` times the output's largest
    |value| (at least 1) of the plain version, and a second launch on
    fresh pools equal bit for bit, pools and output.
    Returns the largest output error against the plain version per pool
    dtype's ``paged_quantize_scatter`` variant."""
    from pytorch_distributed_tpu_torch.ops import paged_flash as pf

    errs = {}
    for kv in QUANT:
        for label, raw in append_shapes(torch, dev):
            inp = quantized(torch, raw, kv)
            inp["q"] = inp["q"].to(torch.bfloat16)
            k, v = new_rows(torch, inp, seed=len(label))
            pools = [inp[n] for n in ("k_pool", "v_pool", "k_scale", "v_scale")]
            where = (inp["block_tables"], inp["q_positions"])
            for split_s in (1, 2, None):
                runs = {}
                for name, fn in (("append", pf.paged_quantize_scatter_attention),
                                 ("again", pf.paged_quantize_scatter_attention),
                                 ("two launches", pf.scatter_then_attend)):
                    mine = [t.clone() for t in pools]
                    runs[name] = (fn(inp["q"], k, v, *mine, *where, split_s=split_s), mine)
                plain = [t.clone() for t in pools]
                want = pf.paged_quantize_scatter_attention_reference(inp["q"], k, v, *plain,
                                                                     *where)
                sync(torch, dev)
                out, mine = runs["append"]
                at = f"append route {label} {kv} pools, split_s={split_s}"

                def differ(xs, ys, first=0):
                    return sum(int((x[first:].view(torch.uint8) != y[first:].view(torch.uint8))
                                   .sum()) for x, y in zip(xs, ys))
                n_pool = differ(mine, plain, first=1)
                n_out = differ([out], [runs["two launches"][0]])
                n_rep = differ([out, *mine], [runs["again"][0], *runs["again"][1]])
                print(f"(b) {at}: pools {'bit-equal' if n_pool == 0 else f'{n_pool} bytes DIFFER'}"
                      f" to the plain scatter's; output {'bit-equal' if n_out == 0 else 'DIFFERS'}"
                      f" to the two-launch route's; two launches "
                      f"{'bitwise equal' if n_rep == 0 else 'DIFFER'}")
                if n_pool or n_out or n_rep:
                    failures.append(at)
                # the new rows reach |x| = 1e2, where one bf16 ulp of the
                # output is 0.5: the tolerance scales with its largest |value|
                tol = BF16_TOL * max(1.0, want.float().abs().max().item())
                err = check_abs(torch, failures, f"{at}, output vs plain", out, want, tol, dev)
                key = pf.variant(pf.QUANTIZE, mine[0].dtype)
                errs[key] = max(errs.get(key, 0.0), err)
    return errs


def match_rate(a, b) -> float:
    """Share of equal tokens at equal places of two lists of streams."""
    return float(np.mean([x == y for s, t in zip(a, b) for x, y in zip(s, t)]))


def flash_inputs(torch, dtype, *, b=8, l=2048, h=12, d=64, lk=None, seed=0, dev="cuda"):
    """q, k, v, dO ``[B, L, H, D]`` of unit-normal noise on the card."""
    rng = np.random.default_rng(seed)
    lk = lk or l
    shapes = [(b, l, h, d), (b, lk, h, d), (b, lk, h, d), (b, l, h, d)]
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(dev, dtype)
            for s in shapes]


def flash_bound(q, k, causal=True, shift=0) -> dict:
    """Least times of the forward and of the backward for these inputs:
    QK and PV (forward) and S, dP, dV, dK, dQ (backward) at 2 flops per
    multiply-add for each visible (q, k) pair; each input read once and
    each output written once (forward: q, k, v, O, LSE; backward: q, k, v,
    O, dO, LSE, dQ, dK, dV). The split backward (``bwd_split``) does the
    same work with 7 products a pair, S and dP in both of its kernels:
    ``bwd_dkv`` S, dP, dV, dK (reading q, k, v, dO, LSE, Δ; writing dK,
    dV) and ``bwd_dq`` S, dP, dQ (the same reads; writing dQ)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    i = np.arange(lq)
    visible = np.clip(i + shift + 1, 0, lk) if causal else np.full(lq, lk)
    pairs = b * h * float(visible.sum())
    elem = q.element_size()
    row_bytes = b * h * d * elem
    rows = b * h * lq * 4
    out = {}
    for name, flops, n_bytes in (
            ("fwd", 4 * d * pairs, row_bytes * (2 * lq + 2 * lk) + rows),
            ("bwd", 10 * d * pairs, row_bytes * (4 * lq + 4 * lk) + rows),
            ("bwd_split", 14 * d * pairs, row_bytes * (4 * lq + 4 * lk) + rows),
            ("bwd_dkv", 8 * d * pairs, row_bytes * (2 * lq + 4 * lk) + 2 * rows),
            ("bwd_dq", 6 * d * pairs, row_bytes * (3 * lq + 2 * lk) + 2 * rows)):
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[str(q.dtype)]
        out[name] = {"bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": n_bytes, "flops": flops}
    return out


def tail_inputs(torch, dtype, b, hw, f, seed=0, dev="cuda"):
    """Tail operands on the card from a seed: z = relu(noise) ``[B, H, W,
    F]``, g and out noise ``[B, H, W, 4F]``, wa ``[4F, F]``, c ``[F, F]``,
    dmn ``[F]`` fp32 at the scales of a backward."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    e = 4 * f

    def noise(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    z = noise(b, hw, hw, f).relu_().to(dtype)
    g, out = (noise(b, hw, hw, e).to(dtype) for _ in range(2))
    return z, g, out, noise(e, f, scale=e ** -0.5), noise(f, f, scale=f ** -1), noise(f)


def tail_bound(name, n, f, e, elem, dtype) -> dict:
    """Least time of each tail kernel for n rows: every input read once and
    every output written once; 2 flops per multiply-add of its product
    (zᵀz as its upper triangle with the diagonal, F(F+1)/2 sums: the other
    half is the same numbers)."""
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

    n_bytes, flops = {
        bt.MOMENTS: (n * f * elem + (f + f * f) * 4, 2 * n * (f * (f + 1) // 2)),
        bt.BWD_REDUCE: (n * f * elem + 3 * n * e * elem + (f * e + e) * 4, 2 * n * f * e),
        bt.BWD_DZ: (n * e * elem + 2 * n * f * elem + (e * f + f * f + f) * 4,
                    2 * n * (e + f) * f),
    }[name]
    return roofline(n_bytes, flops, PEAK_FLOPS[str(dtype)])


def time_ms(torch, fn, iters=100, warmup=5):
    """Mean CUDA-event time of ``fn`` with the 50 MB L2 flushed before each
    call, as a layer's attention finds it in the serving loop (12 layers
    of pools stream through between two calls on one layer). A ~1 ms spin
    on the card before each start event lets the host enqueue ``fn``
    before the card reaches it, so host time stays out of the reading."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def kernel_device_ms(torch, fn, match, iters=10, attempts=6) -> dict:
    """Mean device time per call of ``fn`` of the kernels that each entry of
    ``match`` picks out, from a ``torch.profiler`` trace of ``iters`` calls
    with the L2 flushed before each: for kernels that one call launches back
    to back, where CUDA events around the call time them together. Each
    entry is ``name: (predicate on the kernel's name, launches one call
    makes of the kernels it picks)``. The profiler can drop kernels from a
    trace, so a trace counts only when it holds exactly ``iters`` times each
    entry's launches; another is taken, up to ``attempts`` traces, and then
    this raises: a missed launch never reads as a shorter time. A few
    small unmatched kernels end each trace."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    pad = torch.empty(1, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    want = {name: iters * launches for name, (_, launches) in match.items()}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            for _ in range(4):
                pad.zero_()
            torch.cuda.synchronize()
        out, seen = matched_device_ms(prof.key_averages(), match, iters)
        if seen == want:
            return out
        print(f"(d) the profiler's trace held {seen} launches, not {want}: taken again")
    raise RuntimeError(f"kernel_device_ms: {attempts} traces of {iters} calls each held "
                       f"{seen} launches of the matched kernels, not {want}")


def matched_device_ms(events, match, iters):
    """``(mean device ms per call, launches)`` of each entry of ``match``
    over the averaged kernel events of a trace of ``iters`` calls."""
    out = {name: 0.0 for name in match}
    seen = {name: 0 for name in match}
    for evt in events:
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        for name, (pred, _) in match.items():
            if pred(evt.key):
                out[name] += us / 1e3 / iters
                seen[name] += evt.count
    return out, seen


def is_dkv_kernel(name: str) -> bool:
    """Kernel 6's dK/dV kernel in a profiler trace: the flash backward that
    is not the dQ kernel (the wgmma backward in bf16)."""
    return "flash_bwd" in name and "flash_bwd_dq" not in name


def is_split_kernel(name: str) -> bool:
    """Kernel 8 in a profiler trace (``paged_split_tc_kernel``, bf16 q on
    bf16, int8 and fp8 pools)."""
    return "paged_split_tc" in name


def is_sweep_kernel(name: str) -> bool:
    """Kernel 7 in a profiler trace (``paged_sweep_tc_kernel``, bf16 q on
    bf16, int8 and fp8 pools)."""
    return "paged_sweep_tc" in name


def is_quantize_kernel(name: str) -> bool:
    """Kernel 9, standalone, in a profiler trace (``quantize_scatter_kernel``)."""
    return "quantize_scatter" in name


def is_dq_kernel(name: str) -> bool:
    """Kernel 6's dQ kernel in a profiler trace (``flash_bwd_dq_wgmma_kernel``
    in bf16, ``flash_bwd_dq_kernel`` in fp32)."""
    return "flash_bwd_dq" in name


def check_abs(torch, failures, label, got, want, tol, dev="cuda") -> float:
    """Largest absolute error of ``got`` against ``want``, printed; a
    failure (or a non-finite value) is recorded."""
    sync(torch, dev)
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= tol and torch.isfinite(got).all().item()
    print(f"(b) {label}: max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(label)
    return err


def check_repeat(torch, failures, label, first, second, dev="cuda") -> int:
    """Two launches' outputs (tuples of tensors) bit for bit: the count of
    differing values, printed; a difference is a failure."""
    sync(torch, dev)
    n = 0
    for a, b in zip(first, second):
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
        n += int((a.contiguous().view(bits) != b.contiguous().view(bits)).sum())
    print(f"(b) {label}: two launches {'bitwise equal' if n == 0 else f'differ in {n} values'}")
    if n:
        failures.append(f"{label}: repeat")
    return n


def check_split_kernels(torch, failures, dev="cuda") -> dict:
    """Phase (b) for kernel 6, the split backward (``bwd_impl="split"``),
    at the ``SPLIT_CHECKS`` shapes: dQ, dK and dV against the plain
    version, all on the plain forward's O and LSE, to the flash backward's
    tolerances (bf16 6e-2: S is summed in another order than the plain
    version's and dS rounds to bf16 from it; fp32 1e-4); against the fused
    kernel (kernel 5), whose dK/dV code the dK/dV kernel runs without the
    dQ pass: dK and dV bitwise equal, dQ (summed by the fused kernel's
    fixed-order adds) to the same tolerances; a second launch of each
    backward bitwise equal to the first (the split kernels write each output
    once; the fused kernel adds its dQ tiles in a fixed order); fully masked
    rows with zero dQ. Returns each kernel's largest error
    over the training and ring shapes."""
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    errs = {fa.BWD_DKV: 0.0, fa.BWD_DQ: 0.0}
    for label, dtype_name, causal, shift, shape in SPLIT_CHECKS:
        dtype = getattr(torch, dtype_name)
        tol = BF16_GRAD_TOL if dtype == torch.bfloat16 else FP32_TOL
        shape = dict(shape)
        view = shape.pop("view", None)
        q, k, v, do = flash_inputs(torch, dtype, dev=dev, **shape)
        kw = dict(causal=causal, scale=q.shape[-1] ** -0.5, shift=shift)
        if view is None:
            o, lse = fa.flash_forward_reference(q, k, v, **kw)
        else:  # a zigzag ring visit's operands, as ops/ring_flash.py slices them
            o, lse = fa.flash_forward_reference(q, k, v, causal=True, scale=kw["scale"])
            delta = fa.compute_delta(do, o)
            half = q.shape[1] // 2
            rq, rk = (slice(0, half) if x == 0 else slice(half, None) for x in view)
            q, o, do, k, v = q[:, rq], o[:, rq], do[:, rq], k[:, rk], v[:, rk]
            lse, kw["delta"] = lse[:, :, rq], delta[:, :, rq]
        split = fa.flash_backward(q, k, v, o, lse, do, bwd_impl="split", **kw)
        again = fa.flash_backward(q, k, v, o, lse, do, bwd_impl="split", **kw)
        fused = fa.flash_backward(q, k, v, o, lse, do, bwd_impl="fused", **kw)
        fused_again = fa.flash_backward(q, k, v, o, lse, do, bwd_impl="fused", **kw)
        want = fa.flash_backward_reference(q, k, v, o, lse, do, **kw)
        sync(torch, dev)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32

        def n_diff(a, b):
            return int((a.view(bits) != b.view(bits)).sum())

        for i, name in enumerate(("dQ", "dK", "dV")):
            err = check_abs(torch, failures, f"split bwd {name}, {label}", split[i], want[i],
                            tol, dev)
            if i == 0:
                check_abs(torch, failures, f"split vs fused bwd dQ, {label}", split[0],
                          fused[0], tol, dev)
            else:
                n = n_diff(split[i], fused[i])
                print(f"(b) split vs fused bwd {name}, {label}: "
                      f"{'bitwise equal' if n == 0 else f'differ in {n} values'}")
                if n:
                    failures.append(f"split vs fused bwd {name}, {label}")
            if label.startswith(("training", "ring")):
                key = fa.BWD_DQ if i == 0 else fa.BWD_DKV
                errs[key] = max(errs[key], err)
        check_repeat(torch, failures, f"split bwd, {label}", split, again, dev)
        check_repeat(torch, failures, f"fused bwd, {label}", fused, fused_again, dev)
        if shift < 0 and not (split[0][:, :-shift] == 0).all():
            failures.append(f"split bwd fully masked rows, {label}")
        del q, k, v, do, o, lse, split, again, fused, fused_again, want, kw
        empty_cache(torch, dev)
    return errs


def ring_runs(torch, card, tmp, dev="cuda") -> dict:
    """Phase (c) for the ring: the ranks of ``ring_ranks`` spawned through
    ``tools/ring_check.py`` (the kernels are built already, so the ranks
    only load them). First ``ring_flash_attention`` in ``RING_CASES``,
    gathered and held against single-card flash on the whole sequence
    (``RING_ATTN_RTOL``), with each rank's launches; then ``LMTrainer`` at
    dp 1 x sp ranks with ``ring_flash`` in both layouts, its first step
    against the one-card flash step.
    Returns the split kernels' launches over the split cases and the
    trainer's flash launches. With ``dev="cpu"`` (a rehearsal) the ranks
    meet over gloo on the CPU, where the plain versions launch nothing."""
    from pytorch_distributed_tpu_torch.data import DataLoader, DistributedSampler, to_device
    from pytorch_distributed_tpu_torch.compilecache import serving_registry
    from pytorch_distributed_tpu_torch.data import SyntheticTokens
    from pytorch_distributed_tpu_torch.models.transformer import TransformerConfig
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_tpu_torch.tools import ring_check
    from pytorch_distributed_tpu_torch.train import create_lm_state, lm_collate
    from pytorch_distributed_tpu_torch.train import make_lm_train_step

    bsz, seq, steps = RING["batch"], RING["seq"], RING["steps"]
    heads, n_layers = RING_MODEL["num_heads"], RING_MODEL["num_layers"]
    on_card = 1 if dev == "cuda" else 0  # CPU tensors run the plain versions
    ranks, backend = ring_ranks(torch.cuda.device_count() if dev == "cuda" else 0)
    where = (f"{ranks} ranks on {ranks} cards" if backend == "nccl" else
             f"{ranks} ranks on 1 card, P2P and all-reduce staged through the host")
    print(f"(c) ring: backend {backend}, {where}")
    base = dict(backend=backend, dp=1, sp=ranks, device=dev, timeout_s=RING["timeout_s"])
    empty_cache(torch, dev)

    # ring_flash_attention against single-card flash on the whole sequence
    job = dict(base, task="attention", rendezvous=f"file://{tmp}/rendezvous-attention",
               out=f"{tmp}/attention", dtype="bfloat16", seed=5,
               shape=(bsz, seq, heads, RING_MODEL["embed_dim"] // heads), cases=RING_CASES)
    t0 = time.perf_counter()
    ring_check.run(job, ranks)
    results = ring_check.load(job)
    spawn_s = time.perf_counter() - t0
    q, k, v, do = (torch.from_numpy(x).to(dev, torch.bfloat16)
                   for x in ring_check.attention_inputs(job))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(q, k, v, causal=True)
    o.backward(do)
    want = {"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    split_launches = {fa.BWD_DKV: 0, fa.BWD_DQ: 0}
    failures = []
    for case in RING_CASES:
        name = ring_check.case_name(case)
        errs, rel = {}, {}
        for key in want:
            diff = (ring_check.gather([r[name][key] for r in results], 1, ranks,
                                      case["layout"]).to(dev).float() - want[key].float())
            errs[key] = diff.abs().max().item()
            rel[key] = (diff.norm() / want[key].float().norm()).item()
        fwd = [r[name]["fwd_launches"] for r in results]
        bwd = [r[name]["bwd_launches"] for r in results]
        n_fwd = [n * on_card for n in ring_launches(case["layout"], ranks)]
        bwd_names = (fa.BWD,) if case["bwd_impl"] == "fused" else (fa.BWD_DKV, fa.BWD_DQ)
        launches_ok = all(f[fa.FWD] == n and all(b_[x] == n for x in bwd_names)
                          and sum(b_.values()) == n * len(bwd_names)
                          for f, b_, n in zip(fwd, bwd, n_fwd))
        ok = max(rel.values()) <= RING_ATTN_RTOL and launches_ok
        print(f"(c) ring_flash_attention {name} B={bsz} L={seq} ({seq // ranks} a rank) "
              f"H={heads} D={q.shape[-1]} bf16 vs single-card flash, relative error "
              f"||ring - one card|| / ||one card||: "
              + ", ".join(f"{x} {rel[x.lower()]:.2e}" for x in ("O", "dQ", "dK", "dV"))
              + f" (tol {RING_ATTN_RTOL:g}); max_abs_err "
              + ", ".join(f"{x} {errs[x.lower()]:.3e}" for x in ("O", "dQ", "dK", "dV"))
              + f"; launches per rank: forward {[f[fa.FWD] for f in fwd]}, backward "
              f"{[{x: b_[x] for x in bwd_names} for b_ in bwd]} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        if case["bwd_impl"] == "split":
            for b_ in bwd:
                for x in split_launches:
                    split_launches[x] += b_[x]
    print(f"(c) ring attention: {len(RING_CASES)} cases in {spawn_s:.1f}s of spawned ranks")
    del q, k, v, do, o, want, results
    empty_cache(torch, dev)
    if failures:
        raise SystemExit(f"chip_smoke: the ring disagrees with single-card flash: {failures}")

    # LMTrainer on the ring in both layouts, from the seed-0 weights
    models = {layout: dict(RING_MODEL, max_seq_len=seq, dtype="bfloat16",
                           attention="ring_flash", ring_layout=layout)
              for layout in ("contiguous", "zigzag")}
    job = dict(base, task="trainer", rendezvous=f"file://{tmp}/rendezvous-trainer",
               out=f"{tmp}/trainer", models=models, batch=bsz, seq=seq, steps=steps)
    ring_check.run(job, ranks)
    results = ring_check.load(job)
    # the one-card flash step on the trainer's first batch
    data = SyntheticTokens(steps * bsz, seq, RING_MODEL["vocab_size"])
    loader = DataLoader(data, bsz, lm_collate,
                        sampler=DistributedSampler(len(data), shuffle=True, seed=0))
    first_batch = to_device(next(loader.iter_batches(0)), dev)
    one_card = TransformerConfig(**RING_MODEL, max_seq_len=seq, dtype=torch.bfloat16,
                                 attention="flash")
    st = create_lm_state(one_card, lr_schedule=lambda step: 0.0, device=dev)
    _, m = make_lm_train_step(grad_clip_norm=1.0)(st, first_batch)
    one = {k: float(x) for k, x in m.items()}
    del st, m
    empty_cache(torch, dev)
    trainer_launches = {}
    for layout in models:
        runs = [r[layout] for r in results]
        hist = runs[0]["history"]
        losses = [h["loss"] for h in hist]
        d_loss = abs(hist[0]["loss"] - one["loss"])
        d_norm = abs(hist[0]["grad_norm"] / one["grad_norm"] - 1)
        step_ms = [round(h["step_s"] * 1e3, 1) for h in hist]
        print(f"(c) LMTrainer ring_flash {layout}, dp 1 x sp {ranks}, {steps} steps of "
              f"B={bsz} x L={seq} bf16 (fp32 parameters) on {card}: losses "
              f"{[round(x, 4) for x in losses]}; grad norms "
              f"{[round(h['grad_norm'], 3) for h in hist]}; validation loss "
              f"{runs[0]['val']['loss']:.4f} over {runs[0]['val']['tokens']:.0f} tokens")
        print(f"(c) ring {layout} step times {step_ms} ms ({backend}"
              f"{'-staged: not a speed figure' if backend == 'gloo' else ''}); peak memory per "
              f"rank {[round(r['peak_gib'], 1) for r in runs]} GiB; flash launches per rank in "
              f"training {[r['train_launches'] for r in runs]}, in validation "
              f"{[r['val_launches'] for r in runs]}")
        print(f"(c) ring {layout} first step vs one card (flash): loss {hist[0]['loss']:.5f} vs "
              f"{one['loss']:.5f} (|diff| {d_loss:.2e}, tol {RING_LOSS_TOL:g}); grad norm "
              f"{hist[0]['grad_norm']:.5f} vs {one['grad_norm']:.5f} (rel diff {d_norm:.2e}, "
              f"tol {RING_GRAD_NORM_RTOL:g})")
        if len(losses) != steps or not all(np.isfinite(losses)) or not np.isfinite(
                runs[0]["val"]["loss"]):
            raise SystemExit(f"chip_smoke: ring {layout}: a non-finite or missing loss")
        if not (d_loss <= RING_LOSS_TOL and d_norm <= RING_GRAD_NORM_RTOL):
            raise SystemExit(f"chip_smoke: the ring {layout} step disagrees with one card")
        for r, n in zip(runs, ring_launches(layout, ranks)):
            n *= n_layers * steps * on_card
            if r["train_launches"] != {fa.FWD: n, fa.BWD: n, fa.BWD_DKV: 0, fa.BWD_DQ: 0}:
                raise SystemExit(f"chip_smoke: ring {layout}: launches {r['train_launches']}")
        trainer_launches[layout] = [r["train_launches"] for r in runs]
    return {"split_launches": split_launches, "trainer_launches": trainer_launches}


def dp_tail_batches(torch, dev="cuda") -> list:
    """``(label, dtype, B)`` of the tail kernels' launches in the DP phase
    beyond B = 128 bf16: the fused bf16 ranks and their emulation at
    ``DP["batch"]``, the sync-BN fused fp32 ranks at ``DP["batch"]``, and
    its reference on the concatenated batch of ``ring_ranks``' ranks."""
    ranks = ring_ranks(torch.cuda.device_count() if dev == "cuda" else 0)[0]
    bs = DP["batch"]
    return [(f"DP B={bs}", torch.bfloat16, bs), (f"DP B={bs}", torch.float32, bs),
            (f"DP concatenated B={bs * ranks}", torch.float32, bs * ranks)]


def check_tail_kernels(torch, failures, dev="cuda") -> dict:
    """Phase (b) for the bottleneck tail: each kernel against its plain
    version at ResNet-50's stage shapes (bf16, B = 128), the downsample
    inputs (moments), B = 8 in fp32, the stage shapes and downsample inputs
    at the batches the DP phase runs (``dp_tail_batches``: the grid of
    blocks follows N, so each B is a plan of its own), and ragged shapes;
    fp32 sums relative
    to their largest value, gp bit-equal (a select), dz within a bf16 ulp
    or two of its largest value; moments and tail_bwd_reduce bitwise equal
    over two launches (their chunks are summed in a fixed order). Returns
    each kernel's largest absolute error over the bf16 shapes of the main
    path."""
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

    bf16, f32 = torch.bfloat16, torch.float32

    def check_rel(label, got, want, rtol):
        sync(torch, dev)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-30)
        ok = rel <= rtol and torch.isfinite(got).all().item()
        print(f"(b) {label}: max_abs_err {err:.3e}, relative to max {rel:.2e} (tol {rtol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return err

    def check_moments(shape, z):
        got, want = bt.moments(z), bt.moments_reference(z)
        check_repeat(torch, failures, f"moments, {shape}", got, bt.moments(z), dev)
        return max(check_rel(f"moments Σz, {shape}", got[0], want[0], TAIL_SUM_RTOL),
                   check_rel(f"moments zᵀz, {shape}", got[1], want[1], TAIL_SUM_RTOL))

    def check_reduce(shape, z, g, out):
        """tail_bwd_reduce: gp bit-equal, P and Σgp relative to their largest
        value, two launches bitwise equal. Returns (its error, the plain gp)."""
        (gp, p, sb), (rgp, rp, rsb) = (bt.tail_bwd_reduce(z, g, out),
                                       bt.tail_bwd_reduce_reference(z, g, out))
        check_repeat(torch, failures, f"tail_bwd_reduce, {shape}", (gp, p, sb),
                     bt.tail_bwd_reduce(z, g, out), dev)
        sync(torch, dev)
        bits = torch.int16 if g.dtype == bf16 else torch.int32
        n_diff = int((gp.view(bits) != rgp.view(bits)).sum())
        print(f"(b) tail_bwd_reduce gp, {shape}: "
              f"{'bit-equal' if n_diff == 0 else f'{n_diff} values DIFFER'}")
        if n_diff:
            failures.append(f"tail_bwd_reduce gp, {shape}")
        return max(check_rel(f"tail_bwd_reduce P, {shape}", p, rp, TAIL_SUM_RTOL),
                   check_rel(f"tail_bwd_reduce Σgp, {shape}", sb, rsb, TAIL_SUM_RTOL)), rgp

    def check_tail(label, dtype, b, hw, f, moments_only=False):
        z, g, out, wa, c, dmn = tail_inputs(torch, dtype, b, hw, f, seed=hw + f, dev=dev)
        shape = f"z [{b},{hw},{hw},{f}] E={4 * f} {str(dtype)[6:]}, {label}"
        err = {bt.MOMENTS: check_moments(shape, z)}
        if moments_only:
            return err
        err[bt.BWD_REDUCE], rgp = check_reduce(shape, z, g, out)
        dz = bt.tail_bwd_dz(rgp, z, wa, c, dmn)
        check_repeat(torch, failures, f"tail_bwd_dz, {shape}", (dz,),
                     (bt.tail_bwd_dz(rgp, z, wa, c, dmn),), dev)
        err[bt.BWD_DZ] = check_rel(f"tail_bwd_dz, {shape}", dz,
                                   bt.tail_bwd_dz_reference(rgp, z, wa, c, dmn),
                                   TAIL_DZ_RTOL[str(dtype)])
        return err

    errs = {}

    def keep(err):
        for k, v in err.items():
            errs[k] = max(errs.get(k, 0.0), v)

    for i, (b, hw, f) in enumerate(TAIL_STAGES):
        keep(check_tail(f"stage {i + 1}", bf16, b, hw, f))
        check_tail(f"stage {i + 1}, B=8", f32, 8, hw, f)
    for i, (b, hw, f) in enumerate(TAIL_DOWNSAMPLE):
        keep(check_tail(f"downsample input of stage {i + 1}", bf16, b, hw, f, moments_only=True))
    for label, dtype, b in dp_tail_batches(torch, dev):
        for i, (_, hw, f) in enumerate(TAIL_STAGES):
            err = check_tail(f"stage {i + 1}, {label}", dtype, b, hw, f)
            if dtype == bf16:
                keep(err)
        for i, (_, hw, f) in enumerate(TAIL_DOWNSAMPLE):
            err = check_tail(f"downsample input of stage {i + 1}, {label}", dtype, b, hw, f,
                             moments_only=True)
            if dtype == bf16:
                keep(err)
    for dtype in (bf16, f32):  # ragged: N = 147 rows, and F = 40 (not a whole tile)
        for f in (64, 40):
            check_tail("ragged", dtype, 3, 7, f)
    # rows wider than their channels (column slices, read through the tensor
    # maps' row strides): z for all three kernels, out for tail_bwd_reduce,
    # gp for tail_bwd_dz
    z, g, out, wa, c, dmn = tail_inputs(torch, bf16, 8, 14, 256, seed=3, dev=dev)
    gp = bt.tail_bwd_reduce_reference(z, g, out)[0]
    gpw, zw, ow = (torch.cat([x, x[..., :8]], -1)[..., :x.shape[-1]] for x in (gp, z, out))
    check_moments("z rows 16 bytes wider than their channels, z [8,14,14,256] bf16", zw)
    check_reduce("z and out rows 16 bytes wider than their channels, z [8,14,14,256] E=1024 "
                 "bf16", zw, g, ow)
    check_rel("tail_bwd_dz, gp and z rows 16 bytes wider than their channels, z [8,14,14,256]"
              " bf16", bt.tail_bwd_dz(gpw, zw, wa, c, dmn),
              bt.tail_bwd_dz_reference(gp, z, wa, c, dmn), TAIL_DZ_RTOL[str(bf16)])
    return errs


def resnet_runs(torch, card) -> dict:
    """Phase (c) for ResNet-50: the fused bf16 ``Trainer`` (as bench.py
    builds the model) for ``RESNET["steps"]`` steps and a validation pass,
    with the tail kernels' launches counted; the first step of the fused
    and the plain-block model from the same weights; the fp32 recipe path.
    Returns the fused training run's step times, medians from the second
    step on: ``step_s`` (a step's wall, making its batch included),
    ``data_s`` (making and copying the batch) and ``net_s`` (the step
    without it)."""
    from pytorch_distributed_tpu_torch.data import (
        SyntheticImageClassification,
        image_collate,
        to_device,
    )
    from pytorch_distributed_tpu_torch.models.convert import (
        init_resnet_params,
        resnet_params_from_jax,
    )
    from pytorch_distributed_tpu_torch.models.resnet import resnet50
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt
    from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
    from pytorch_distributed_tpu_torch.ops.optim import global_norm
    from pytorch_distributed_tpu_torch.recipes import resnet_single
    from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig, create_resnet_state

    bf16 = torch.bfloat16
    tail = (bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ)

    def data(n, seed=0):
        return SyntheticImageClassification(n, 224, 1000, seed=seed)

    rb, steps = RESNET["batch"], RESNET["steps"]
    trainer = Trainer(resnet50(dtype=bf16, fused_bottleneck=True), data(steps * rb),
                      data(rb, seed=1),
                      # each batch made on this thread before its step and kept out
                      # of the step time, as in the earlier readings: threads making
                      # float noise would slow the step they overlap
                      TrainerConfig(epochs=1, batch_size=rb, precision="bf16", log_every=1,
                                    num_workers=0, prefetch=1),
                      device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bt.reset_launch_counts()
    trainer.train_epoch(0)
    torch.cuda.synchronize()
    launches = dict(bt.launch_counts)
    bt.reset_launch_counts()
    val = trainer.validate()
    val_launches = dict(bt.launch_counts)
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    step_s = [r["step_s"] - r["data_s"] for r in hist[1:]]
    p50 = float(np.median(step_s))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"(c) ResNet-50 fused bottleneck, bf16 compute on fp32 parameters, SGD(0.1, 0.9, "
          f"1e-4), {steps} steps of B={rb} x 224^2 on {card}: losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"(c) step p50 {p50 * 1e3:.1f} ms ({rb / p50:.0f} img/s; steps "
          f"{[round(x * 1e3, 1) for x in step_s]} ms; first step {hist[0]['step_s']:.2f} s; "
          f"making and copying a batch {np.median([r['data_s'] for r in hist]) * 1e3:.0f} ms, "
          f"outside the step time), peak memory {peak:.1f} GiB; tail launches per step "
          f"{ {k: launches[k] / steps for k in tail} }; validation acc1 {val['acc1']:.2f} loss "
          f"{val['loss']:.4f} over {val['count']:.0f} images, tail launches {val_launches}")
    if len(losses) != steps or not all(np.isfinite(losses)) or not np.isfinite(val["loss"]):
        raise SystemExit(f"chip_smoke: a non-finite or missing ResNet loss: {losses}")
    wrong = launch_problems(launches, val_launches, steps, RESNET_TAIL_LAUNCHES)
    if wrong:
        raise SystemExit(f"chip_smoke: the fused ResNet-50's tail launches: {wrong}")
    synthetic = {"step_s": float(np.median([r["step_s"] for r in hist[1:]])),
                 "data_s": float(np.median([r["data_s"] for r in hist[1:]])), "net_s": p50}
    del trainer
    torch.cuda.empty_cache()

    # the first step from the same weights on the same batch: fused vs plain
    tree = init_resnet_params(resnet50(), seed=0)
    cb = RESNET["compare_batch"]
    cdata = data(cb, seed=2)
    batch = to_device({k: torch.from_numpy(v) for k, v in image_collate(
        [cdata[i] for i in range(cb)]).items()}, "cuda")
    for dtype in (torch.float32, bf16):
        first = {}
        for fused in (True, False):
            st = create_resnet_state(resnet50(dtype=dtype, fused_bottleneck=fused),
                                     lr_schedule=lambda step: 0.0,
                                     params=resnet_params_from_jax(tree, fused=fused),
                                     device="cuda")
            st.model.train()
            loss = cross_entropy_loss(st.model(batch["image"]), batch["label"])
            loss.backward()
            first[fused] = (loss.item(),
                            global_norm([q.grad for q in st.model.parameters()]).item())
            del st, loss
            torch.cuda.empty_cache()
        d_loss = abs(first[True][0] - first[False][0])
        d_norm = abs(first[True][1] / first[False][1] - 1)
        tol_loss, tol_norm = RESNET_FIRST_STEP_TOL[str(dtype)]
        print(f"(c) ResNet-50 first step B={cb}, fused vs plain blocks, {str(dtype)[6:]}: loss "
              f"{first[True][0]:.5f} vs {first[False][0]:.5f} (|diff| {d_loss:.2e}, tol "
              f"{tol_loss:g}); grad norm {first[True][1]:.5f} vs {first[False][1]:.5f} "
              f"(rel diff {d_norm:.2e}, tol {tol_norm:g})")
        if not (d_loss <= tol_loss and d_norm <= tol_norm):
            raise SystemExit("chip_smoke: the fused ResNet-50 step disagrees with the plain one")

    # the recipe path: fp32, plain blocks, full width; no tail kernel runs
    nb, nsteps = RESNET["recipe_batch"], RESNET["recipe_steps"]
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        summary = resnet_single.main(
            ["--synthetic", "--epochs", "1", "--batch-size", str(nb), "--device", "cuda",
             "--save-dir", tmp], datasets=(data(nsteps * nb), data(nb, seed=1), 224, 1000))
    torch.cuda.synchronize()
    print(f"(c) recipes/resnet_single.py, fp32 plain blocks, {nsteps} steps of B={nb} and a "
          f"validation batch: {time.perf_counter() - t0:.1f} s, val loss {summary['loss']:.4f} "
          f"acc1 {summary['acc1']:.2f}; tail launches {dict(bt.launch_counts)} (the plain "
          f"blocks launch none)")
    if not np.isfinite(summary["loss"]) or any(bt.launch_counts.values()):
        raise SystemExit(f"chip_smoke: the fp32 recipe run failed: {summary}, "
                         f"{bt.launch_counts}")
    return synthetic


def launch_problems(launches: dict, val_launches: dict, steps: int, per_step) -> list:
    """What is wrong with a ResNet run's tail launches: each kernel
    ``per_step`` times a step over ``steps`` steps, none in validation."""
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

    tail = (bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ)
    wrong = [f"{k}: {launches.get(k, 0)} launches in {steps} steps, want {n * steps}"
             for k, n in zip(tail, per_step) if launches.get(k, 0) != n * steps]
    if any(val_launches.values()):
        wrong.append(f"validation launched tail kernels: {val_launches}")
    return wrong


def loader_threads() -> list:
    """Names of the loader's threads still alive (producers, workers)."""
    import threading

    from pytorch_distributed_tpu_torch.data.loader import PRODUCER_THREAD

    return [t.name for t in threading.enumerate() if t.name.startswith(PRODUCER_THREAD)]


def data_runs(torch, card, tmp, synthetic, dev="cuda") -> dict:
    """Phase (c) for the input pipeline, every split under ``tmp``:

    - packs raw splits (``DATA``: train and val records of seeded uint8
      images at the stored size, no PIL) and opens each with the native
      reader (fails a split opened without it);
    - (i) the loader's img/s: the random crop on the native whole-batch
      path and on the per-sample path at 0 and ``workers`` threads, the
      validation center crop, and the first batch of the two crop paths
      bit-equal; an epoch with each batch copied to the card, one batch's
      copy alone (uint8, and the same pixels as float32); where PIL
      imports, also the JPEG split and ``rrc`` (it never fails for want
      of PIL);
    - (ii) ``DATA_MODEL`` (bench.py's fused bf16 ResNet-50) in ``Trainer``
      for an epoch of the train split (``workers`` threads, ``prefetch``)
      and a validation pass: losses finite, 20 / 16 / 16 tail launches a
      step and none in validation, every batch made by the native crop,
      no loader thread left; step p50, img/s, the wait for a batch and the
      peak memory beside ``synthetic`` (``resnet_runs``' timing);
    - (iii) ``recipes/resnet_single.py --raw --raw-aug crop`` (fp32, plain
      blocks) and (iv) ``recipes/resnet_ddp.py`` from raw splits, on the
      ranks of ``ring_ranks`` over NCCL with 2-4 cards, else a world of
      one.

    Returns what was measured and the fused run's tail launches. With
    ``dev="cpu"`` (a rehearsal) the plain versions launch nothing."""
    import importlib

    from pytorch_distributed_tpu_torch.data import (
        DataLoader,
        ImageNet,
        RawImageNet,
        write_imagenet_raw_split,
    )
    from pytorch_distributed_tpu_torch.data import transforms as T
    from pytorch_distributed_tpu_torch.data.imagenet import write_imagenet_split
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt
    from pytorch_distributed_tpu_torch.tools import bench_data, dp_check
    from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    parts = {}
    on_card = 1 if dev == "cuda" else 0
    host = f"{card}; host {os.cpu_count()} cores"
    d = DATA
    bs, workers, prefetch = d["batch"], d["workers"], d["prefetch"]

    def pack(name, n_train, n_val, seed):
        root = os.path.join(tmp, name)
        os.makedirs(root)
        for split, n, s in (("train", n_train, seed), ("val", n_val, seed + 1)):
            write_imagenet_raw_split(os.path.join(root, f"{split}.rawtprc"),
                                     bench_data.raw_images(n, d["size"], s), d["size"])
        return root

    def opened(ds):
        if ds.reader._native is None:
            raise SystemExit(f"chip_smoke: {ds.path} was opened without the native reader")
        return ds

    main_dir = pack("raw", d["train"], d["val"], 0)
    mb = sum(os.path.getsize(os.path.join(main_dir, f)) for f in os.listdir(main_dir)) / 1e6
    parts["pack"] = time.perf_counter() - t_phase
    print(f"(c) data: packed {d['train']} train and {d['val']} val raw records of "
          f"{d['size']}^2 uint8 images ({mb:.1f} MB) in {parts['pack']:.1f} s")

    # (i) the loader's rates
    t0 = time.perf_counter()
    crop = opened(RawImageNet("train", main_dir, d["crop"], aug="crop"))
    plain = RawImageNet("train", main_dir, d["crop"], aug="crop", use_native=False)
    val = opened(RawImageNet("val", main_dir, d["crop"], aug="none"))
    first = DataLoader(crop, bs).collate(range(bs))
    first_plain = DataLoader(plain, bs).collate(range(bs))
    equal = crop.native_batches == 1 and all(torch.equal(first[k], first_plain[k])
                                             for k in first)
    print(f"(c) data: the first batch of the native crop bit-equal to the per-sample path's "
          f"{'ok' if equal else 'FAIL'}")
    if not equal:
        raise SystemExit("chip_smoke: the native crop disagrees with the per-sample path")
    rates = {}
    for label, ds, counts in (("raw crop, native", crop, (0, workers)),
                              ("raw crop, per sample", plain, (0, workers)),
                              ("raw val center crop, native", val, (workers,))):
        want = len(ds) // bs if ds.reader._native is not None else 0
        for w in counts:
            before = ds.native_batches
            rates[f"{label}, {w} workers"] = bench_data.loader_rate(
                label, ds, w, prefetch, bs)["img_s"]
            if ds.native_batches - before != want:
                raise SystemExit(f"chip_smoke: {label}: {ds.native_batches - before} of "
                                 f"{len(ds) // bs} batches made by the native crop, want {want}")
    have_pil = bench_data.have_pil()
    if have_pil:
        jpeg_dir = os.path.join(tmp, "jpeg")
        os.makedirs(jpeg_dir)
        write_imagenet_split(os.path.join(jpeg_dir, "train.tprc"),
                             bench_data.jpeg_images(d["jpeg"], d["size"]))
        jpeg = opened(ImageNet("train", T.train_transform(d["crop"]), jpeg_dir))
        rates[f"jpeg rrc, {workers} workers"] = bench_data.loader_rate(
            "jpeg rrc", jpeg, workers, prefetch, bs)["img_s"]
        rates[f"raw rrc, {workers} workers"] = bench_data.loader_rate(
            "raw rrc", opened(RawImageNet("train", main_dir, d["crop"], aug="rrc")), workers,
            prefetch, bs)["img_s"]
    e2e = bench_data.end_to_end(crop, workers, dev, prefetch, bs)
    copies = {"uint8": e2e["copy_ms"]}
    if dev == "cuda":
        f32 = {"image": first["image"].float().pin_memory(), "label": first["label"]}
        copies["float32"] = bench_data.copy_ms(f32, dev)
    parts["rates"] = time.perf_counter() - t0
    print(f"(c) data: loader img/s at B={bs}, prefetch {prefetch} ({host}): "
          + "; ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    print(f"(c) data: {'PIL present: the JPEG split and rrc ran' if have_pil else 'PIL not installed: the JPEG split and rrc were not run'}")
    print(f"(c) data: an epoch of the native crop with each batch copied to {dev}: "
          f"{e2e['img_s']:.1f} img/s; one batch's copy {e2e['batch_mb']:.1f} MB uint8 "
          f"{copies['uint8']:.3f} ms" + (f", the same pixels as float32 "
                                          f"{copies['float32']:.3f} ms" if "float32" in copies
                                          else "") + f" ({host})")

    # (ii) the fused bf16 ResNet-50 fed from the raw split
    t0 = time.perf_counter()
    train_ds = opened(RawImageNet("train", main_dir, d["crop"], aug="crop"))
    val_ds = opened(RawImageNet("val", main_dir, d["crop"], aug="none"))
    steps = d["train"] // bs
    trainer = Trainer(dp_check.build_model(DATA_MODEL), train_ds, val_ds,
                      TrainerConfig(epochs=1, batch_size=bs, precision="bf16", log_every=1,
                                    num_workers=workers, prefetch=prefetch,
                                    save_dir=os.path.join(tmp, "trainer")), device=dev)
    sync(torch, dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bt.reset_launch_counts()
    trainer.train_epoch(0)
    sync(torch, dev)
    launches = dict(bt.launch_counts)
    bt.reset_launch_counts()
    summary = trainer.validate()
    val_launches = dict(bt.launch_counts)
    hist = trainer.history
    losses = [r["loss"] for r in hist]
    step_s = float(np.median([r["step_s"] for r in hist[1:]]))
    data_s = float(np.median([r["data_s"] for r in hist[1:]]))
    net_s = float(np.median([r["step_s"] - r["data_s"] for r in hist[1:]]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda" else 0.0
    left = loader_threads()
    wrong = launch_problems(launches, val_launches, steps,
                            [n * on_card for n in RESNET_TAIL_LAUNCHES])
    native_ok = (train_ds.native_batches == steps
                 and val_ds.native_batches == len(trainer.val_loader))
    print(f"(c) data: fused bf16 ResNet-50 from the raw split, {steps} steps of B={bs} "
          f"x {d['crop']}^2 (random crop and flip, {workers} loader threads, {prefetch} "
          f"batches ahead): losses {[round(x, 4) for x in losses]}; step p50 "
          f"{step_s * 1e3:.1f} ms ({bs / step_s:.1f} img/s), of which waiting for and copying "
          f"a batch {data_s * 1e3:.2f} ms, without it {net_s * 1e3:.1f} ms; first step "
          f"{hist[0]['step_s']:.2f} s; peak memory "
          f"{peak:.1f} GiB; the synthetic run's step p50 without making its batch "
          f"{synthetic['net_s'] * 1e3:.1f} ms (making and copying it on this thread "
          f"{synthetic['data_s'] * 1e3:.1f} ms) ({host})")
    print(f"(c) data: tail launches per step "
          f"{ {k: v / steps for k, v in launches.items()} }, in validation {val_launches}; "
          f"native batches {train_ds.native_batches} train, {val_ds.native_batches} val; "
          f"validation loss {summary['loss']:.4f} over {summary['count']:.0f} images; loader "
          f"threads alive after the runs {left} "
          f"{'ok' if not (wrong or left) and native_ok else 'FAIL'}")
    if (len(losses) != steps or not all(np.isfinite(losses))
            or not np.isfinite(summary["loss"])):
        raise SystemExit(f"chip_smoke: a non-finite or missing loss fed from records: {losses}")
    if wrong or left or not native_ok:
        raise SystemExit(f"chip_smoke: the record-fed run: {wrong}, threads {left}, native "
                         f"batches {train_ds.native_batches} / {val_ds.native_batches}")
    del trainer
    empty_cache(torch, dev)
    parts["trainer"] = time.perf_counter() - t0

    # (iii), (iv) the recipes from raw splits (fp32 plain blocks: no tail launch)
    t0 = time.perf_counter()
    ranks, backend = ring_ranks(torch.cuda.device_count() if dev == "cuda" else 0)
    world = ranks if backend == "nccl" else 1
    extra = ["--device", "cpu"] if dev == "cpu" else []
    recipes = {}
    for recipe, b, n_steps, w in (("resnet_single", d["recipe_batch"], d["recipe_steps"], 1),
                                  ("resnet_ddp", d["dp_batch"], d["dp_steps"], world)):
        root = pack(recipe, b * n_steps * w, b * w, len(recipes) + 10)
        mod = importlib.import_module(f"pytorch_distributed_tpu_torch.recipes.{recipe}")
        bt.reset_launch_counts()
        t1 = time.perf_counter()
        summary = mod.main(["--data-dir", root, "--raw", "--raw-aug", "crop", "--epochs", "1",
                            "--batch-size", str(b), "--save-dir", os.path.join(root, "out")]
                           + extra)
        sync(torch, dev)
        ok = (np.isfinite(summary.get("loss", np.nan)) and summary.get("count") == b * w
              and not any(bt.launch_counts.values()))
        recipes[recipe] = dict(seconds=time.perf_counter() - t1, ranks=w, **summary)
        print(f"(c) data: recipes/{recipe}.py --raw --raw-aug crop on {w} rank(s), {n_steps} "
              f"steps of B={b} a rank and a validation batch: {recipes[recipe]['seconds']:.1f} "
              f"s, val loss {summary.get('loss', float('nan')):.4f} over "
              f"{summary.get('count', 0):.0f} images, tail launches {dict(bt.launch_counts)} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: recipes/{recipe}.py from a raw split failed: "
                             f"{summary}")
        empty_cache(torch, dev)
    parts["recipes"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    print(f"(c) data phase: {wall:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return {"rates": rates, "end_to_end": e2e, "copy_ms": copies, "pil": have_pil,
            "step_s": step_s, "data_s": data_s, "net_s": net_s, "peak_gib": peak,
            "losses": losses,
            "tail_launches": launches, "recipes": recipes, "wall_s": wall}


def _child(runs, card, kw) -> dict:
    """``runs(torch, card, tmp, **kw)`` on the card in this (spawned)
    process, under a temporary directory, with main's numerics settings."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        return runs(torch, card, tmp, **kw)


def in_child(runs, card, **kw) -> dict:
    """A phase's ``runs`` in a process of its own, which ends with it: run
    in this process, the data phase's and the FSDP phase's recipe runs
    left a trainer's loader behind, and every later ``torch.profiler``
    trace of it short of launches, so phase (d)'s device times failed
    (PERF.md §7)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx, max_tasks_per_child=1) as ex:
        return ex.submit(_child, runs, card, kw).result()


def state_copy(torch, trainer) -> dict:
    """The trainer's checkpoint leaves, cloned where they live."""
    from pytorch_distributed_tpu_torch.train.state import state_payload

    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state_payload(trainer.state).items()}


def leaf_group(path: str) -> str:
    """A checkpoint leaf's group in the resume checks."""
    if path.startswith("state/optimizer/"):
        return "optimizer"
    if path.startswith("state/model/"):
        return "bn stats" if "/running_" in path else "params"
    return "counts"


def state_diff(torch, got: dict, want: dict) -> dict:
    """Largest |got - want| of each leaf group (``leaf_group``); a leaf
    missing, of another shape, or a count that differs is inf."""
    out: dict = {}
    for k in set(got) | set(want):
        g = leaf_group(k)
        a, b = got.get(k), want.get(k)
        if a is None or b is None:
            d = float("inf")
        elif isinstance(b, torch.Tensor):
            d = (float((a.double() - b.double()).abs().max()) if a.shape == b.shape
                 else float("inf")) if b.numel() else 0.0
        else:
            d = 0.0 if a == b else float("inf")
        out[g] = max(out.get(g, 0.0), d)
    return out


def check_resumed(failures, label, repeat: dict, resumed: dict) -> None:
    """Each leaf group of a resumed run against the uninterrupted one:
    bitwise where two uninterrupted runs are bitwise equal, else within
    twice their difference."""
    for g in sorted(repeat):
        r, d = repeat[g], resumed.get(g, float("inf"))
        ok = d == 0.0 if r == 0.0 else d <= 2 * r
        verdict = ("bitwise" if d == 0.0 else "within 2x the repeat") if ok else "FAIL"
        print(f"(c) {label}: {g} max |resumed - uninterrupted| {d:.3g}, two uninterrupted "
              f"runs {r:.3g}: {verdict}")
        if not ok:
            failures.append(f"{label}: {g} {d:.3g} against a repeat of {r:.3g}")


def save_line(card, label, save: dict, restore_s: float) -> str:
    gb = save["bytes"] / 1e9
    stages = ", ".join(f"{k} {save[k] * 1e3:.1f} ms" for k in ("snapshot", "copy", "write",
                                                              "commit"))
    total = sum(save[k] for k in ("snapshot", "copy", "write", "commit"))
    return (f"(c) {label} checkpoint {gb:.3f} GB: save {stages} ({total * 1e3:.1f} ms, "
            f"{gb / max(total, 1e-9):.2f} GB/s); restore {restore_s * 1e3:.1f} ms "
            f"({gb / max(restore_s, 1e-9):.2f} GB/s); {card}")


def resume_runs(torch, card, tmp, dev="cuda") -> dict:
    """Phase (c) for suspend, resume, fallback and rollback, through
    ``Trainer.fit`` / ``LMTrainer.fit`` with ``save_dir`` under ``tmp``,
    cuDNN set to its deterministic algorithms for the phase:

    - the fused bf16 ResNet-50 (RESUME): two uninterrupted runs (their
      difference is the card's own repeat difference), a run suspended at
      ``suspend_at`` (``go_suspend``'s SystemExit caught here) that a fresh
      trainer resumes, its resumed steps' tail launches counted; a run with
      interval saves, whose newest step checkpoint is truncated, that a
      fresh trainer resumes from the one before; a run with two NaN
      batches, ``nan_guard`` and ``max_bad_steps`` 2, which rolls back once
      and must end where the same run ends skipping only;
    - the full-width LM: two uninterrupted runs, a suspend at
      ``lm_suspend_at`` and its resume, the resumed steps' flash launches;
    - the ranks of ``ring_ranks`` (``tools/resume_check.py``): SIGUSR1 to
      rank 1 alone, both ranks save at the same step and exit 0, and a
      resume on the same ranks;
    - the save's stages and the restore timed for both checkpoints.

    Each resumed state is held against the uninterrupted run by
    ``check_resumed``. With ``dev="cpu"`` (a rehearsal) the plain versions
    launch nothing."""
    import gc
    import shutil

    from pytorch_distributed_tpu_torch.data import SyntheticImageClassification, SyntheticTokens
    from pytorch_distributed_tpu_torch.models.transformer import TransformerConfig
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_tpu_torch.resilience import faults
    from pytorch_distributed_tpu_torch.resilience.faults import FaultPlan, FaultSpec
    from pytorch_distributed_tpu_torch.tools import dp_check, resume_check
    from pytorch_distributed_tpu_torch.train import (
        LMTrainer,
        LMTrainerConfig,
        Trainer,
        TrainerConfig,
    )
    from pytorch_distributed_tpu_torch.utils.suspend import SuspendWatcher

    t_phase = time.perf_counter()
    on_card = 1 if dev == "cuda" else 0
    failures: list = []
    out: dict = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def release(*dirs):
        for d in dirs:
            shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)
        gc.collect()
        empty_cache(torch, dev)

    def fit(trainer, plan=()):
        """Fit under ``plan`` with the launch counters reset; the exit code
        of a suspend (else None), the launches, the restore's seconds."""
        faults.install_plan(FaultPlan([FaultSpec(**f) for f in plan]) if plan else None)
        restore, try_resume = [0.0], trainer.try_resume

        def timed():
            t0 = time.perf_counter()
            found = try_resume()
            restore[0] = time.perf_counter() - t0
            return found

        trainer.try_resume = timed
        bt.reset_launch_counts()
        fa.reset_launch_counts()
        code = None
        try:
            trainer.fit()
        except SystemExit as e:
            code = e.code
        finally:
            faults.clear_plan()
        sync(torch, dev)
        return code, {**bt.launch_counts, **fa.launch_counts}, restore[0]

    def suspend_plan(at):
        return [dict(site="train.step", kind="suspend", at=at)]

    try:
        # ---- ResNet-50, fused bf16 ----
        rb, rsteps, k = RESUME["batch"], RESUME["steps"], RESUME["suspend_at"]
        size, classes = RESUME["size"], RESUME_RESNET["num_classes"]
        train = SyntheticImageClassification(rsteps * rb, size, classes)
        val = SyntheticImageClassification(rb, size, classes, seed=1)

        def resnet(d, watcher=None, **over):
            cfg = TrainerConfig(epochs=1, batch_size=rb, lr=0.1, precision="bf16", log_every=0,
                                save_dir=os.path.join(tmp, d), **over)
            return Trainer(dp_check.build_model(RESUME_RESNET), train, val, cfg, device=dev,
                           suspend_watcher=watcher)

        runs = {}
        for name in ("a1", "a2"):
            t = resnet(name)
            fit(t)
            runs[name] = state_copy(torch, t)
            del t
            release(name)
        repeat = state_diff(torch, runs["a1"], runs["a2"])
        t = resnet("s", SuspendWatcher(install_handlers=False))
        code, _, _ = fit(t, suspend_plan(k))
        suspend_save = t.ckpt.last_save
        if code != 0 or t.state.step != k + 1 or not t.ckpt.has_latest():
            failures.append(f"ResNet-50 suspend at step {k}: exit {code}, step {t.state.step}")
        del t
        t = resnet("s")
        _, launches, restore_s = fit(t)
        tail = [launches[n] for n in (bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ)]
        want = [n * (rsteps - k - 1) * on_card for n in RESNET_TAIL_LAUNCHES]
        print(f"(c) ResNet-50 fused bf16, B={rb}, {rsteps} steps, suspended at step {k} and "
              f"resumed by a fresh Trainer: resumed steps' tail launches {tail} (want {want}: "
              f"{RESNET_TAIL_LAUNCHES} a step)")
        if tail != want:
            failures.append(f"ResNet-50 resumed tail launches {tail}, want {want}")
        check_resumed(failures, "ResNet-50 suspend/resume", repeat,
                      state_diff(torch, state_copy(torch, t), runs["a1"]))
        del t
        release("s")

        # interval saves; the newest one torn; the fallback
        t = resnet("e", save_every_n_steps=RESUME["every"])
        fit(t)
        interval_save = t.ckpt.last_save
        print(save_line(card, "ResNet-50 suspend (blocking)", suspend_save, restore_s))
        print(save_line(card, "ResNet-50 non-blocking", interval_save, restore_s))
        out["resnet"] = dict(suspend_save=suspend_save, interval_save=interval_save,
                             restore_s=restore_s, tail_launches=tail, repeat=repeat)
        check_resumed(failures, "ResNet-50 with interval saves", repeat,
                      state_diff(torch, state_copy(torch, t), runs["a1"]))
        saved = [p for _s, p in t.ckpt.step_checkpoints()]
        del t
        shard = next(os.path.join(saved[-1], n) for n in os.listdir(saved[-1])
                     if n.endswith(".npz"))
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) // 2)
        t = resnet("e", save_every_n_steps=RESUME["every"])
        found = t.ckpt.newest_restorable()
        fit(t)
        print(f"(c) ResNet-50 interval saves {[os.path.basename(p) for p in saved]}, the newest "
              f"truncated: resumed from {os.path.basename(found or 'nothing')}")
        if found != saved[-2]:
            failures.append(f"the fallback resumed from {found}, not {saved[-2]}")
        check_resumed(failures, "ResNet-50 fallback past a torn checkpoint", repeat,
                      state_diff(torch, state_copy(torch, t), runs["a1"]))
        del t
        release("e")

        # two NaN batches: skip only, and rollback after 2 bad steps
        nan = [dict(site="train.step", kind="nan", at=RESUME["nan_at"], times=2)]
        t = resnet("k", nan_guard=True)
        fit(t, nan)
        skipped = state_copy(torch, t)
        del t
        release("k")
        t = resnet("n", nan_guard=True, max_bad_steps=2, save_every_n_steps=RESUME["every"])
        fit(t, nan)
        print(f"(c) ResNet-50 NaN batches at steps {RESUME['nan_at']} and "
              f"{RESUME['nan_at'] + 1}, nan_guard, max_bad_steps 2: {t.rollbacks} rollback(s), "
              f"{t.guard.bad_total} skipped steps, updates {t.state.updates} of {t.state.step}")
        if t.rollbacks != 1:
            failures.append(f"the NaN run rolled back {t.rollbacks} times, not once")
        check_resumed(failures, "ResNet-50 rollback against the skip-only run", repeat,
                      state_diff(torch, state_copy(torch, t), skipped))
        del t, runs, skipped
        release("n")

        parts = {"ResNet-50": time.perf_counter() - t_phase}

        # ---- the full-width LM, bf16 on fp32 parameters, AdamW ----
        lb, lseq, lsteps, lk = (RESUME[n] for n in ("lm_batch", "lm_seq", "lm_steps",
                                                    "lm_suspend_at"))
        cfg = TransformerConfig(**RESUME_LM, max_seq_len=lseq, dtype=torch.bfloat16,
                                attention="flash")
        ltrain = SyntheticTokens(lsteps * lb, lseq, cfg.vocab_size)
        lval = SyntheticTokens(lb, lseq, cfg.vocab_size, seed=1)

        def lm(d, watcher=None):
            return LMTrainer(cfg, ltrain, lval, LMTrainerConfig(
                batch_size=lb, lr=3e-4, warmup_steps=0, grad_clip_norm=1.0, log_every=0,
                save_dir=os.path.join(tmp, d)), device=dev, suspend_watcher=watcher)

        lruns = {}
        for name in ("l1", "l2"):
            t = lm(name)
            fit(t)
            lruns[name], lm_best = state_copy(torch, t), t.ckpt.last_save
            del t
            release(name)
        lrepeat = state_diff(torch, lruns["l1"], lruns["l2"])
        t = lm("ls", SuspendWatcher(install_handlers=False))
        code, _, _ = fit(t, suspend_plan(lk))
        lm_suspend = t.ckpt.last_save
        if code != 0 or t.state.step != lk + 1:
            failures.append(f"LM suspend at step {lk}: exit {code}, step {t.state.step}")
        del t
        t = lm("ls")
        _, launches, lm_restore = fit(t)
        val_batches = len(t.val_loader)
        n = cfg.num_layers
        got = [launches[fa.FWD], launches[fa.BWD]]
        want = [n * (lsteps - lk - 1 + val_batches) * on_card, n * (lsteps - lk - 1) * on_card]
        print(f"(c) LM {n} layers x {cfg.embed_dim}, B={lb} x {lseq}, {lsteps} steps, suspended "
              f"at step {lk} and resumed: flash forward / fused backward launches {got} (want "
              f"{want}: {n} each a resumed step, {n} forwards a validation batch)")
        if got != want:
            failures.append(f"LM resumed flash launches {got}, want {want}")
        check_resumed(failures, "LM suspend/resume", lrepeat,
                      state_diff(torch, state_copy(torch, t), lruns["l1"]))
        print(save_line(card, "LM suspend (blocking)", lm_suspend, lm_restore))
        print(save_line(card, "LM best (non-blocking)", lm_best, lm_restore))
        out["lm"] = dict(suspend_save=lm_suspend, best_save=lm_best, restore_s=lm_restore,
                         flash_launches=got, repeat=lrepeat)
        del t, lruns
        release("ls")

        parts["LM"] = time.perf_counter() - t_phase - sum(parts.values())

        # ---- ranks: only rank 1 is signalled ----
        ranks, backend = ring_ranks(torch.cuda.device_count() if dev == "cuda" else 0)
        db, dsteps = RESUME["dp_batch"], RESUME["dp_steps"]
        job = dict(backend=backend, device=dev, timeout_s=RESUME["timeout_s"],
                   cudnn_deterministic=True, model=RESUME_RESNET,
                   data=dict(n_train=dsteps * db * ranks, n_val=db * ranks, size=size,
                             classes=classes),
                   config=dict(epochs=1, batch_size=db, lr=0.1, precision="bf16", log_every=0),
                   rendezvous=f"file://{tmp}/rendezvous-resume1", out=f"{tmp}/resume1",
                   runs=[dict(name="full", dir=f"{tmp}/dp-full"),
                         dict(name="repeat", dir=f"{tmp}/dp-repeat"),
                         dict(name="suspend", dir=f"{tmp}/dp-suspend",
                              signal=[1, RESUME["dp_signal"]])])
        resume_check.run(job, ranks)
        first = resume_check.load(job, ranks)
        job = dict(job, rendezvous=f"file://{tmp}/rendezvous-resume2", out=f"{tmp}/resume2",
                   runs=[dict(name="resume", dir=f"{tmp}/dp-suspend")])
        resume_check.run(job, ranks)
        second = resume_check.load(job, ranks)
        at = [r["suspend"]["suspended_at"] for r in first]
        codes = [r["suspend"]["exit"] for r in first]
        print(f"(c) {ranks} ranks ({backend}), B={db} a rank: SIGUSR1 to rank 1 alone before "
              f"step {RESUME['dp_signal']}: each rank saved at (epoch, step) {at}, exit codes "
              f"{codes}; resumed steps {[r['resume']['step'] for r in second]}")
        if len(set(at)) != 1 or at[0] != (0, RESUME["dp_signal"] + 1) or codes != [0] * ranks:
            failures.append(f"the ranks did not agree on the suspend: {at}, exits {codes}")
        if any(r["resume"]["checksums"] != second[0]["resume"]["checksums"] for r in second):
            failures.append("the resumed ranks' states differ")
        full = first[0]["full"]["state"]
        check_resumed(failures, f"{ranks}-rank suspend/resume", state_diff(
            torch, first[0]["repeat"]["state"], full),
            state_diff(torch, second[0]["resume"]["state"], full))
        out["ranks"] = dict(ranks=ranks, backend=backend, suspended_at=at)
        parts["ranks"] = time.perf_counter() - t_phase - sum(parts.values())
        del first, second, full
    finally:
        torch.backends.cudnn.deterministic = deterministic
        faults.clear_plan()
    if failures:
        raise SystemExit(f"chip_smoke: the resume phase failed: {failures}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"(c) resume phase: {out['wall_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return out


def emulate_dp(torch, spec, batches, ranks, dev="cuda") -> dict:
    """The DP step in one process, the reference for the ranks: from the
    seed-0 weights, each replica's rows (``tools/dp_check.rows``) through
    the model in turn from the same BatchNorm statistics, the gradients
    summed by autograd and divided by ``ranks``, the replicas' running
    statistics averaged, then SGD at ``DP_SCHEDULE``'s lr. ``ranks=1`` is
    one rank on the whole batch. Returns each step's global loss and
    gradient norm, the combined gradient of the first step, and the state
    dict after the first step and the last."""
    from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
    from pytorch_distributed_tpu_torch.ops.optim import global_norm
    from pytorch_distributed_tpu_torch.ops.schedules import step_lr
    from pytorch_distributed_tpu_torch.tools import dp_check
    from pytorch_distributed_tpu_torch.train import create_resnet_state

    state = create_resnet_state(dp_check.build_model(spec), lr_schedule=step_lr(*DP_SCHEDULE),
                                device=dev)
    model, opt = state.model, state.optimizer
    model.train()
    out = {"loss": [], "grad_norm": []}
    for i, batch in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        old = [b.clone() for b in model.buffers()]
        new = []
        loss_sum = torch.zeros((), device=dev)
        for r in range(ranks):
            with torch.no_grad():
                for b, o in zip(model.buffers(), old):
                    b.copy_(o)
            local = {k: v.to(dev) for k, v in dp_check.rows(batch, r, ranks).items()}
            logits = model(local["image"])
            cross_entropy_loss(logits, local["label"]).backward()
            with torch.no_grad():
                loss_sum += cross_entropy_loss(logits, local["label"], reduction="sum")
            new.append([b.clone() for b in model.buffers()])
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        with torch.no_grad():
            torch._foreach_div_(grads, float(ranks))
            for j, b in enumerate(model.buffers()):
                b.copy_(sum(n[j] for n in new) / ranks)
        for group in opt.param_groups:
            group["lr"] = state.lr_schedule(i)
        opt.step()
        out["loss"].append((loss_sum / len(batch["label"])).item())
        out["grad_norm"].append(global_norm(grads).item())
        if i == 0:
            out["first"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
            out["grad_first"] = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                                 if p.grad is not None}
    out["last"] = {k: v.detach() for k, v in model.state_dict().items()}
    return out


def rel_err(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def state_rel_err(torch, got: dict, want: dict, buffers: bool = False) -> float:
    """||got - want|| / ||want|| over the parameters (``buffers``: the
    BatchNorm running statistics) of state dict ``want``, or over every
    tensor of a gradient dict."""
    keys = [k for k in want if k.endswith(("running_mean", "running_var")) == buffers]
    diff = sum(float((got[k].to(want[k].device).float() - want[k].float()).norm()) ** 2
               for k in keys)
    return (diff / sum(float(want[k].float().norm()) ** 2 for k in keys)) ** 0.5


def dp_runs(torch, card, tmp, dev="cuda") -> dict:
    """Phase (c) for data parallelism, the ranks of ``ring_ranks`` spawned
    through ``tools/dp_check.py`` (the kernels are built already, so the
    ranks only load them): DP steps of the fused bf16 and the plain fp32
    ResNet-50 against ``emulate_dp`` on the same card, with 20 / 16 / 16
    tail launches a step on each rank of the fused one; sync-BN (fused and
    plain, fp32) against one rank on the concatenated batch; the fp16
    scaler skipping a step on every rank for an inf on rank 1; the three
    recipes; with 2-4 cards (NCCL) the step times at 1, 2 and 4 cards and
    back, each rank's device time split into NCCL kernels and the rest.
    Returns what was measured. With ``dev="cpu"`` (a rehearsal) the ranks
    meet over gloo on the CPU, where the plain versions launch nothing."""
    import importlib

    from pytorch_distributed_tpu_torch.data import SyntheticImageClassification
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt
    from pytorch_distributed_tpu_torch.tools import dp_check

    ranks, backend = ring_ranks(torch.cuda.device_count() if dev == "cuda" else 0)
    on_card = 1 if dev == "cuda" else 0
    where = (f"{ranks} ranks on {ranks} cards" if backend == "nccl" else
             f"{ranks} ranks on 1 card, the all-reduces staged through the host")
    print(f"(c) data parallel: backend {backend}, {where}")
    bs, steps = DP["batch"], DP["steps"]
    plain = dict(DP_MODEL, dtype="float32")
    cases = {
        "fused bf16": dict(model=dict(DP_MODEL, dtype="bfloat16", fused=True)),
        "plain fp32": dict(model=plain),
        "sync-BN fused fp32": dict(model=dict(plain, fused=True, sync_bn=True)),
        "sync-BN plain fp32": dict(model=dict(plain, sync_bn=True)),
        "fp16 scaler (fp32 compute)": dict(model=plain, scaler={}, plant=DP_PLANT),
    }
    cases = {k: dict(c, schedule=DP_SCHEDULE) for k, c in cases.items()}
    data = dict(n=steps, batch=bs * ranks, size=DP_SIZE, classes=DP_MODEL["num_classes"],
                seed=3)
    job = dict(task="steps", backend=backend, rendezvous=f"file://{tmp}/rendezvous-dp",
               out=f"{tmp}/dp", device=dev, timeout_s=DP["timeout_s"], cases=cases, data=data)
    empty_cache(torch, dev)
    t0 = time.perf_counter()
    dp_check.run(job, ranks)
    results = dp_check.load(job, ranks)
    print(f"(c) DP steps: {len(cases)} cases x {steps} steps of B={bs} a rank x {DP_SIZE}^2 "
          f"in {time.perf_counter() - t0:.1f}s of spawned ranks")
    batches = dp_check.global_batches(job)
    failures = []
    measured = {}
    for name, case in cases.items():
        runs = [r[name] for r in results]
        got = runs[0]["metrics"]
        spec = case["model"]
        step_ms = [round(x * 1e3, 1) for x in got["step_s"]]
        launches = [r["metrics"]["launches"] for r in runs]
        want_launches = (list(RESNET_TAIL_LAUNCHES) if spec.get("fused") else [0, 0, 0])
        launches_ok = all(per_step == [n * on_card for n in want_launches]
                          for rank in launches for per_step in rank)
        same = all(np.array_equal(r["metrics"]["loss"], got["loss"], equal_nan=True)
                   for r in runs)
        print(f"(c) DP {name}: losses {[round(x, 5) for x in got['loss']]}, grad norms "
              f"{[round(x, 5) for x in got['grad_norm']]}; step times {step_ms} ms "
              f"({backend}{'-staged: not a speed figure' if backend == 'gloo' else ''}); "
              f"tail launches a step per rank {[rank[0] for rank in launches]} "
              f"{'ok' if launches_ok else 'FAIL'}")
        if not (launches_ok and same):
            failures.append(f"{name}: launches {launches} or metrics differ between ranks")
        if name.startswith("fp16"):
            scale = got["scale"]
            ok = (all(r["metrics"]["grads_finite"] == [1.0, 0.0, 1.0] for r in runs)
                  and all(r["metrics"]["param_change"][DP_PLANT[0]] == 0.0
                          and r["metrics"]["momentum_change"][DP_PLANT[0]] == 0.0
                          and r["updates"] == steps - 1 for r in runs)
                  and scale[DP_PLANT[0]] == scale[0] / 2 == 2.0 ** 15)
            moved = [(r["metrics"]["param_change"][DP_PLANT[0]],
                      r["metrics"]["momentum_change"][DP_PLANT[0]]) for r in runs]
            print(f"(c) DP {name}: an inf on rank {DP_PLANT[1]} at step {DP_PLANT[0]}: "
                  f"grads_finite {got['grads_finite']}, scale {scale}, largest parameter / "
                  f"momentum change at that step on each rank {moved}, "
                  f"updates {[r['updates'] for r in runs]} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(name)
            continue
        synced = spec.get("sync_bn", False)
        ref = emulate_dp(torch, dict(spec, sync_bn=False), batches, 1 if synced else ranks, dev)
        per_step = {k: [rel_err(a, b) for a, b in zip(got[k], ref[k])]
                    for k in ("loss", "grad_norm")}
        errs = dict(per_step, grad_first=state_rel_err(torch, runs[0]["grad_first"],
                                                       ref["grad_first"]))
        for when, key in (("first", "first"), ("last", "params")):
            for part in ("params", "buffers"):
                errs[f"{part}_{when}"] = state_rel_err(torch, runs[0][key], ref[when],
                                                       part == "buffers")
        tol = DP_SYNC_RTOL if synced else DP_EMULATION_RTOL[spec["dtype"]]
        ok = all(e <= t for k in per_step for e, t in zip(errs[k], tol[k])) and all(
            errs[k] <= tol[k] for k in tol if k not in per_step)
        against = "one rank on the concatenated batch" if synced else "the one-process emulation"
        print(f"(c) DP {name} vs {against}: relative error by step, loss "
              f"{[f'{x:.2e}' for x in errs['loss']]} (tol {list(tol['loss'])}), grad norm "
              f"{[f'{x:.2e}' for x in errs['grad_norm']]} (tol {list(tol['grad_norm'])}); "
              f"step-0 gradient {errs['grad_first']:.2e} (tol {tol['grad_first']}); "
              f"parameters and BatchNorm statistics after step 0 {errs['params_first']:.2e}, "
              f"{errs['buffers_first']:.2e} (tol {tol.get('params_first', 'the gradient')}, "
              f"{tol['buffers_first']}), after {steps} steps {errs['params_last']:.2e}, "
              f"{errs['buffers_last']:.2e} (tol {tol['params_last']}, {tol['buffers_last']}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        if name == "plain fp32":  # per-replica statistics, for the sync-BN check's yardstick
            per_replica_grad = ref["grad_first"]
        elif name == "sync-BN plain fp32":
            # what a sum left out (each rank its own statistics) would give
            # against the concatenated batch: the tolerance must tell it apart
            errs["per_replica_grad_first"] = state_rel_err(torch, per_replica_grad,
                                                           ref["grad_first"])
            apart = errs["per_replica_grad_first"] > 2 * tol["grad_first"]
            print(f"(c) DP per-replica statistics (the plain fp32 emulation) vs one rank on the "
                  f"concatenated batch: step-0 gradient {errs['per_replica_grad_first']:.2e}, "
                  f"more than twice the sync-BN tolerance {tol['grad_first']} "
                  f"{'ok' if apart else 'FAIL'}")
            if not apart:
                failures.append("the sync-BN gradient tolerance does not tell a missing sum")
        measured[name] = dict(errs, step_ms=step_ms)
        del ref
        empty_cache(torch, dev)
    del results
    if failures:
        raise SystemExit(f"chip_smoke: data parallel disagrees: {failures}")

    # the recipes: a world of one on one card, a rank a card on more
    world = ranks if backend == "nccl" else 1
    rb, rsteps = DP["recipe_batch"], DP["recipe_steps"]
    classes = DP_MODEL["num_classes"]
    extra = ["--device", "cpu", "--tiny"] if dev == "cpu" else []
    for recipe in ("resnet_dp", "resnet_ddp", "resnet_ddp_amp"):
        mod = importlib.import_module(f"pytorch_distributed_tpu_torch.recipes.{recipe}")
        bt.reset_launch_counts()
        t0 = time.perf_counter()
        summary = mod.main(["--synthetic", "--epochs", "1", "--batch-size", str(rb),
                            "--save-dir", f"{tmp}/{recipe}"] + extra,
                           datasets=(SyntheticImageClassification(rsteps * rb * world, DP_SIZE,
                                                                  classes),
                                     SyntheticImageClassification(rb * world, DP_SIZE, classes,
                                                                  seed=1), DP_SIZE, classes))
        sync(torch, dev)
        ok = np.isfinite(summary.get("loss", np.nan)) and summary.get("count") == rb * world
        print(f"(c) recipes/{recipe}.py on {world} rank(s), {rsteps} steps of B={rb} a rank and "
              f"a validation batch: {time.perf_counter() - t0:.1f} s, val loss "
              f"{summary.get('loss', float('nan')):.4f} over {summary.get('count', 0):.0f} "
              f"images {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: recipes/{recipe}.py failed: {summary}")
        empty_cache(torch, dev)

    if backend != "nccl":
        print("(c) DP step times across cards: need 2-4 cards (NCCL); not measured here")
        return {"cases": measured, "timing": None}
    return {"cases": measured, "timing": dp_timing(torch, card, tmp, ranks, dev)}


def pp_launches(n_layers: int, stages: int, microbatches: int) -> int:
    """Flash forward (and fused backward) launches of one pipeline step on
    each stage: its layers once a microbatch, no recomputation."""
    return n_layers // stages * microbatches


def step_errs(failures: list, got: dict, want: dict, what: str, rtol: dict) -> dict:
    """Relative error of each step's metric of ``got`` against ``want`` for
    each key of ``rtol`` (a limit a step), printed; ``what`` joins
    ``failures`` when a step misses or a value is not finite."""
    errs = {k: [rel_err(a, b) for a, b in zip(got[k], want[k])] for k in rtol}
    ok = all(len(got[k]) == len(want[k]) and all(np.isfinite(got[k])) and
             all(e <= t for e, t in zip(errs[k], rtol[k])) for k in rtol)
    print(f"(c) {what}: relative error by step, "
          + "; ".join(f"{k} {[f'{e:.2e}' for e in errs[k]]} (tol {list(rtol[k])})"
                      for k in rtol) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(what)
    return errs


def parallel_runs(torch, card, tmp, dev="cuda", recipes=True) -> dict:
    """Phase (c) for ZeRO-3 FSDP and the GPipe pipeline (``PARALLEL``), the
    ranks of ``ring_ranks`` spawned once through ``tools/parallel_check.py``:
    the full-width LM under FSDP and replicated DP (each step's loss and
    grad norm, ``PARALLEL_RTOL``, and the validation loss; FSDP's first
    step also against the one-card step at the global batch), the
    pipeline with a stage a rank against ``make_pp_reference_step`` on one
    card from the same stacked weights and its validation loss against
    the plain eval step on the reference's weights, each stage's embedding
    and head equal, the fused bf16 ResNet-50's ``Trainer(fsdp=True)``
    against ``tools/dp_check.py``'s replicated trainer on the same ranks
    at ``RESNET_FSDP_LR`` (an epoch of the DP phase's steps and a
    validation batch, ``RESNET_FSDP_RTOL``), each rank's flash and tail
    launches a step against the table's, its parameter and optimizer
    bytes and peak memory against the replicated run's, step p50 and busy
    share; then, with ``recipes``, the recipe with ``--fsdp`` and
    ``--pipeline-stages 2`` (its refusal on one card). Returns the
    launches for the kernels line. With ``dev="cpu"`` (a rehearsal) the
    ranks meet over gloo on the CPU."""
    from pytorch_distributed_tpu_torch.models.convert import (
        init_params,
        params_from_jax,
        pp_stack,
        pp_unstack,
    )
    from pytorch_distributed_tpu_torch.models.transformer import TransformerConfig
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
    from pytorch_distributed_tpu_torch.tools import dp_check, parallel_check
    from pytorch_distributed_tpu_torch.train import (
        create_lm_state,
        empty_lm_metrics,
        lm_collate,
        make_lm_eval_step,
        make_lm_train_step,
        pp,
    )

    t_phase = time.perf_counter()
    on_card = 1 if dev == "cuda" else 0
    ranks, backend = ring_ranks(torch.cuda.device_count() if dev == "cuda" else 0)
    where = (f"{ranks} ranks on {ranks} cards" if backend == "nccl" else
             f"{ranks} ranks on 1 card, collectives and P2P staged through the host")
    print(f"(c) FSDP and pipeline: backend {backend}, {where}")
    bsz, seq, steps, micro = (PARALLEL[k] for k in ("batch", "seq", "steps", "microbatches"))
    n_layers = RING_MODEL["num_layers"]
    model = dict(RING_MODEL, max_seq_len=seq, dtype="bfloat16", attention="flash")
    vocab = RING_MODEL["vocab_size"]
    rng = np.random.default_rng(11)
    batches = [lm_collate(list(rng.integers(1, vocab, (bsz, seq)).astype(np.int32)))
               for _ in range(steps)]
    val = [lm_collate(list(rng.integers(1, vocab, (bsz, seq)).astype(np.int32)))]
    lm = {"fsdp": dict(model=model, mode="fsdp", clip=1.0),
          "replicated": dict(model=model, mode="replicated", clip=1.0, profiled=0)}
    image = dict(task="image_trainer", model=dict(DP_MODEL, dtype="bfloat16", fused=True),
                 data=dict(n_train=DP["steps"] * DP["batch"] * ranks, n_val=DP["batch"] * ranks,
                           size=DP_SIZE, classes=DP_MODEL["num_classes"]))
    trainers = {f"resnet {m}": dict(image, config=dict(
        epochs=1, batch_size=DP["batch"], lr=RESNET_FSDP_LR, precision="bf16", num_workers=0,
        log_every=1, save_dir=os.path.join(tmp, m), fsdp=m == "fsdp"))
        for m in ("fsdp", "replicated")}
    # one spawn of the ranks: the data grid for FSDP, then a stage a rank
    job = dict(task="many", backend=backend, device=dev, timeout_s=PARALLEL["timeout_s"],
               schedule=PARALLEL_SCHEDULE, profiled=PARALLEL["profiled"] * on_card,
               params_out=False, dp=ranks, rendezvous=f"file://{tmp}/rendezvous-parallel",
               out=f"{tmp}/parallel", jobs={
                   "lm": dict(task="lm", cases=lm, batches=batches, val_batches=val),
                   **trainers,
                   "pp": dict(task="lm", dp=1, mp=ranks, batches=batches, val_batches=val,
                              cases={"pp": dict(model=model, mode="pp", clip=1.0,
                                                microbatches=micro)})})
    empty_cache(torch, dev)
    t0 = time.perf_counter()
    parallel_check.run(job, ranks)
    results = parallel_check.load(job)
    print(f"(c) {ranks} ranks: {time.perf_counter() - t0:.1f}s spawned, built and run")
    failures = []
    staged = "-staged: not a speed figure" if backend == "gloo" else ""

    def device_ms(rank_runs):
        return [(round(x["nccl_ms"], 1), round(x["compute_ms"], 1)) if "nccl_ms" in x else None
                for x in rank_runs]

    def per_step(got, want, what, rtol):
        return step_errs(failures, got, want, what, rtol)

    # ---- FSDP and replicated DP, the LM ----
    runs = {m: [r["lm"][m] for r in results] for m in lm}
    f0, r0 = runs["fsdp"][0], runs["replicated"][0]
    want_launches = [n_layers * on_card] * 2
    fsdp_launches = [x["metrics"]["launches"] for x in runs["fsdp"]]
    launches_ok = all(step_l == want_launches for rank in fsdp_launches for step_l in rank)
    share = [f["state_bytes"] / r["state_bytes"] for f, r in zip(runs["fsdp"],
                                                                  runs["replicated"])]
    for mode in lm:
        m = runs[mode][0]["metrics"]
        print(f"(c) LM {mode} dp {ranks}, {steps} steps of B={bsz // ranks} a rank x L={seq} "
              f"bf16 on {card}: losses {[round(x, 5) for x in m['loss']]}, grad norms "
              f"{[round(x, 4) for x in m['grad_norm']]}; step p50 "
              f"{np.median(m['step_s']) * 1e3:.1f} ms ({backend}{staged}), busy share "
              f"{[round(x.get('busy', float('nan')), 3) for x in runs[mode]]} (device ms a "
              f"step in NCCL / the rest {device_ms(runs[mode])}); parameter + "
              f"optimizer bytes per rank {[x['state_bytes'] for x in runs[mode]]}, peak memory "
              f"{[round(x['peak_gib'], 2) for x in runs[mode]]} GiB")
    share_ok = all(x <= FSDP_STATE_SHARE for x in share) or ranks == 1
    print(f"(c) LM FSDP: flash forward / backward launches a step per rank "
          f"{[rank[0] for rank in fsdp_launches]} (want {want_launches}) "
          f"{'ok' if launches_ok else 'FAIL'}; state bytes / replicated "
          f"{[round(x, 4) for x in share]} (at most {FSDP_STATE_SHARE}) "
          f"{'ok' if share_ok else 'FAIL'}")
    if not (launches_ok and share_ok):
        failures.append("FSDP launches or state bytes")
    fsdp_errs = per_step(f0["metrics"], r0["metrics"], "LM FSDP vs replicated DP on the same "
                         "ranks", PARALLEL_RTOL)
    # the validation batch after the steps: FSDP's eval step gathers the
    # parts as its train step does
    fv, rv = f0["val"], r0["val"]
    fsdp_val_launches = [x["val_launches"] for x in runs["fsdp"]]
    fl, rl = (v["loss_sum"] / max(v["tokens"], 1) for v in (fv, rv))
    val_err = rel_err(fl, rl)
    ok = (fv["tokens"] == rv["tokens"] > 0 and val_err <= PARALLEL_RTOL["loss"][0]
          and all(v == [n_layers * on_card, 0] for v in fsdp_val_launches))
    print(f"(c) LM FSDP validation vs replicated DP: loss {fl:.5f} vs {rl:.5f} over "
          f"{rv['tokens']:.0f} tokens (relative error {val_err:.2e}, tol {PARALLEL_RTOL['loss'][0]:g}); flash launches per "
          f"rank {fsdp_val_launches} (want [{n_layers * on_card}, 0]) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("FSDP validation")
    # the one-card step at the global batch, from the same weights
    cfg = TransformerConfig(**dict(model, dtype=torch.bfloat16))
    init = params_from_jax(init_params(cfg, 0))
    st = create_lm_state(cfg, lr_schedule=lambda step: 0.0, params=init, device=dev)
    _, m = make_lm_train_step(grad_clip_norm=1.0)(
        st, {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()})
    one = {k: float(x) for k, x in m.items()}
    del st, m
    empty_cache(torch, dev)
    d_loss = abs(f0["metrics"]["loss"][0] - one["loss"])
    d_norm = abs(f0["metrics"]["grad_norm"][0] / one["grad_norm"] - 1)
    ok = d_loss <= RING_LOSS_TOL and d_norm <= RING_GRAD_NORM_RTOL
    print(f"(c) LM FSDP first step vs one card at B={bsz}: loss {f0['metrics']['loss'][0]:.5f} "
          f"vs {one['loss']:.5f} (|diff| {d_loss:.2e}, tol {RING_LOSS_TOL:g}); grad norm rel "
          f"diff {d_norm:.2e} (tol {RING_GRAD_NORM_RTOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("FSDP first step vs one card")

    # ---- the pipeline against the one-card sequential reference ----
    pruns = [r["pp"]["pp"] for r in results]
    want_pp = pp_launches(n_layers, ranks, micro) * on_card
    pp_launch = [x["metrics"]["launches"] for x in pruns]
    pp_val = [x["val_launches"] for x in pruns]
    pp_ok = (all(step_l == [want_pp] * 2 for rank in pp_launch for step_l in rank)
             and all(v == [want_pp, 0] for v in pp_val))
    same = all(x["replicated"] == pruns[0]["replicated"] for x in pruns)
    pm, pv = pruns[-1]["metrics"], pruns[-1]["val"]
    print(f"(c) LM pipeline, {ranks} stages of {n_layers // ranks} layers, {steps} steps of "
          f"B={bsz} x L={seq} in {micro} microbatches on {card}: losses "
          f"{[round(x, 5) for x in pm['loss']]}, grad norms "
          f"{[round(x, 4) for x in pm['grad_norm']]}; "
          f"step p50 {np.median(pm['step_s']) * 1e3:.1f} ms ({backend}{staged}), busy share "
          f"{[round(x.get('busy', float('nan')), 3) for x in pruns]} (device ms a step in NCCL / "
          f"the rest {device_ms(pruns)}), bubble (S-1)/(M+S-1) "
          f"{pm['pp_bubble_frac'][0]:.3f}; parameter + optimizer bytes per stage "
          f"{[x['state_bytes'] for x in pruns]}, peak memory "
          f"{[round(x['peak_gib'], 2) for x in pruns]} GiB")
    print(f"(c) LM pipeline: flash forward / backward launches a step per stage "
          f"{[rank[0] for rank in pp_launch]}, in validation {pp_val} (want {want_pp} each, "
          f"(L/S)·M, no recomputation) {'ok' if pp_ok else 'FAIL'}; every stage's embedding "
          f"and head bit-equal {'ok' if same else 'FAIL'}")
    if not (pp_ok and same):
        failures.append("pipeline launches or replicated leaves")
    st = pp.create_pp_reference_state(cfg, ranks, lr_schedule=warmup_cosine(*PARALLEL_SCHEDULE),
                                      weight_decay=0.1, params=pp_stack(init, ranks), device=dev)
    del init
    ref_step = pp.make_pp_reference_step(cfg, ranks, micro, grad_clip_norm=1.0)
    ref = {"loss": [], "grad_norm": []}
    for b in batches:
        st, m = ref_step(st, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        for k in ref:
            ref[k].append(float(m[k]))
    pp_errs = per_step(pm, ref, "LM pipeline vs the one-card sequential reference",
                       PARALLEL_RTOL)
    # the validation batch: the reference's weights after its steps
    # through the plain model's eval step
    plain = create_lm_state(cfg, lr_schedule=lambda step: 0.0, device=dev,
                            params=pp_unstack(st.model.stacked_state_dict()))
    del st, m
    acc = make_lm_eval_step()(plain, {k: torch.from_numpy(v).to(dev) for k, v in val[0].items()},
                              empty_lm_metrics(dev))
    ref_val = float(acc["loss_sum"]) / max(float(acc["tokens"]), 1)
    del plain, acc
    empty_cache(torch, dev)
    pp_val_loss = pv["loss_sum"] / max(pv["tokens"], 1)
    val_err = rel_err(pp_val_loss, ref_val)
    ok = all(x["val"] == pv for x in pruns) and val_err <= PARALLEL_RTOL["loss"][0]
    print(f"(c) LM pipeline validation vs the reference's weights in the plain eval step: loss "
          f"{pp_val_loss:.5f} vs {ref_val:.5f} over {pv['tokens']:.0f} tokens, the same on every "
          f"stage (relative error {val_err:.2e}, tol {PARALLEL_RTOL['loss'][0]:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("pipeline validation")

    # ---- ResNet-50: Trainer(fsdp=True) against the replicated trainer ----
    rr = {m: [r[f"resnet {m}"] for r in results] for m in ("fsdp", "replicated")}
    steps_r = DP["steps"]
    tail_want = [n * steps_r * on_card for n in RESNET_TAIL_LAUNCHES]
    tail_got = [[x["launches"].get(k, 0) for k in (bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ)]
                for x in rr["fsdp"]]
    tail_ok = all(t == tail_want for t in tail_got)
    for m, runs_r in rr.items():
        hist = runs_r[0]["history"]
        print(f"(c) ResNet-50 fused bf16 Trainer(fsdp={m == 'fsdp'}) dp {ranks}, {len(hist)} "
              f"steps of B={DP['batch']} a rank at lr {RESNET_FSDP_LR:g} on {card}: losses "
              f"{[round(h['loss'], 5) for h in hist]}; step times "
              f"{[round(h['step_s'] * 1e3, 1) for h in hist]} ms ({backend}{staged}); validation "
              f"loss {runs_r[0]['val']['loss']:.5f}, acc1 {runs_r[0]['val']['acc1']:.2f}; "
              f"parameter + momentum bytes per rank {[x['state_bytes'] for x in runs_r]}, peak "
              f"memory {[round(x['peak_gib'], 2) for x in runs_r]} GiB")
    print(f"(c) ResNet-50 FSDP: tail launches in {steps_r} steps per rank {tail_got} (want "
          f"{tail_want}) {'ok' if tail_ok else 'FAIL'}")
    if not tail_ok:
        failures.append("ResNet FSDP tail launches")
    hf, hr = ([h["loss"] for h in rr[m][0]["history"]] for m in ("fsdp", "replicated"))
    resnet_errs = per_step({"loss": hf}, {"loss": hr}, "ResNet-50 Trainer(fsdp=True) vs the "
                           "replicated trainer", {"loss": RESNET_FSDP_RTOL["loss"]})
    vf, vr = (rr[m][0]["val"] for m in ("fsdp", "replicated"))
    val_err = rel_err(vf["loss"], vr["loss"])
    ok = vf["count"] == vr["count"] > 0 and val_err <= RESNET_FSDP_RTOL["val"]
    print(f"(c) ResNet-50 FSDP validation vs the replicated trainer: loss {vf['loss']:.5f} vs "
          f"{vr['loss']:.5f} over {vr['count']:.0f} images (relative error {val_err:.2e}, tol "
          f"{RESNET_FSDP_RTOL['val']:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("ResNet FSDP validation")
    resnet_errs["val"] = val_err

    # ---- the recipe: --fsdp, and --pipeline-stages 2 (refused on one card) ----
    # in this process: on one card the recipe trains here, on more it
    # spawns its ranks
    from pytorch_distributed_tpu_torch.recipes import lm_pretrain

    recipe = {}
    extra = ["--device", "cpu", "--tiny"] if dev == "cpu" else ["--synthetic"]
    cards = torch.cuda.device_count() if dev == "cuda" else 2
    for label, flags in ((("--fsdp", ["--fsdp"]),
                          ("--pipeline-stages 2", ["--pipeline-stages", "2"])) if recipes else ()):
        argv = [*extra, *flags, "--steps", str(PARALLEL["recipe_steps"]), "--epochs", "1",
                "--log-every", "1", "--save-dir", os.path.join(tmp, label[2:6])]
        t0 = time.perf_counter()
        refused = label.startswith("--pipeline") and cards < 2
        try:
            summary, error = lm_pretrain.main(argv), ""
        except SystemExit as e:
            summary, error = {}, str(e)
        secs = time.perf_counter() - t0
        empty_cache(torch, dev)
        if refused:
            ok = "needs a card per rank" in error
            what = f"refused on {cards} card: {error[:60]}..."
        else:
            ok = not error and np.isfinite(summary.get("loss", float("nan")))
            what = f"validation loss {summary.get('loss')}{error}"
        print(f"(c) recipes/lm_pretrain.py {label}: {what} in {secs:.1f}s "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"lm_pretrain {label}: {error}")
        recipe[label] = {"seconds": secs, "loss": summary.get("loss"), "error": error}

    wall = time.perf_counter() - t_phase
    print(f"(c) FSDP and pipeline phase: {wall:.1f} s")
    if failures:
        raise SystemExit(f"chip_smoke: FSDP or the pipeline failed: {failures}")
    flash = {fa.FWD: sum(s_[0] for x in runs["fsdp"] for s_ in x["metrics"]["launches"])
             + sum(s_[0] for x in pruns for s_ in x["metrics"]["launches"])
             + sum(v[0] for v in pp_val + fsdp_val_launches),
             fa.BWD: sum(s_[1] for x in runs["fsdp"] for s_ in x["metrics"]["launches"])
             + sum(s_[1] for x in pruns for s_ in x["metrics"]["launches"])}
    tail = {k: sum(t[i] for t in tail_got)
            for i, k in enumerate((bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ))}
    return {"flash_launches": flash, "tail_launches": tail, "fsdp_errs": fsdp_errs,
            "pp_errs": pp_errs, "resnet_errs": resnet_errs, "state_share": share,
            "recipe": recipe, "wall_s": wall}


def tp_ranks(cards: int) -> tuple:
    """``(ranks, backend)`` of the tensor-parallel phase: 2 ranks sharing
    one card (or the CPU) over gloo, 2 ranks on 2-3 cards and 4 on 4 or
    more over NCCL, a rank a card."""
    return (2, "gloo") if cards < 2 else (4 if cards >= 4 else 2, "nccl")


def predicted_share(torch, model: dict) -> float:
    """A TP rank's share of the parameters of ``model`` (a spec with
    ``tp_size``): the leaves a placement rule claims split T ways, the
    rest whole."""
    from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
    from pytorch_distributed_tpu_torch.parallel.tensor import match_partition_rules
    from pytorch_distributed_tpu_torch.tools.ring_check import _model_config
    from pytorch_distributed_tpu_torch.train.lm import lm_placement_rules, unsharded

    cfg = _model_config(model)
    with torch.device("meta"):
        sizes = {n: p.numel() for n, p in TransformerLM(unsharded(cfg)).named_parameters()}
    rules = match_partition_rules(lm_placement_rules(cfg), sizes)
    local = sum(n / cfg.tp_size if rules[k] is not None else n for k, n in sizes.items())
    return local / sum(sizes.values())


def tp_model(t: int, **kw) -> dict:
    """The phase's model spec at ``t`` tensor-parallel ranks."""
    model = dict(RING_MODEL, max_seq_len=TP["seq"], dtype="bfloat16", attention="flash", **kw)
    if t > 1:
        model.update(tp_size=t, model_axis="model")
    return model


def tp_kernel_checks(torch, card, failures, batch=8, seq=2048) -> dict:
    """Kernels 4 and 5 at the TP ranks' shapes (``TP_KERNEL_HEADS``: H 6 at
    T 2, H 3 at T 4; D 64, bf16), q, k and v the strided views of one
    fused ``[B, L, 3, H, D]`` projection as the model hands them over:
    against their plain versions, then timed (CUDA events, the wrapper as
    the step calls it) beside causal SDPA and the bound."""
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    out = {}
    for h in TP_KERNEL_HEADS:
        rng = np.random.default_rng(20 + h)
        qkv = torch.from_numpy(rng.standard_normal((batch, seq, 3, h, 64), np.float32)).to(
            "cuda", torch.bfloat16)
        q, k, v = qkv.unbind(2)
        do = torch.from_numpy(rng.standard_normal((batch, seq, h, 64), np.float32)).to(
            "cuda", torch.bfloat16)
        sc = 64 ** -0.5
        o, lse = fa.launch_forward(q, k, v, True, sc, 0)
        ro, rlse = fa.flash_forward_reference(q, k, v, causal=True, scale=sc)
        label = f"B={batch} L={seq} H={h} D=64 causal bf16, strided q/k/v"
        err_o = check_abs(torch, failures, f"flash fwd O, {label}", o, ro, BF16_TOL)
        check_abs(torch, failures, f"flash fwd LSE, {label}", lse, rlse, LSE_TOL)
        grads = fa.launch_backward(q, k, v, ro, rlse, do, True, sc, 0)
        want = fa.flash_backward_reference(q, k, v, ro, rlse, do, causal=True, scale=sc)
        err_g = max(check_abs(torch, failures, f"flash bwd {n}, {label}", g, w, BF16_GRAD_TOL)
                    for n, g, w in zip(("dQ", "dK", "dV"), grads, want))
        fb = flash_bound(q, k)
        qg, kg, vg = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        dog = do.transpose(1, 2).contiguous()
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        times = {
            fa.FWD: (time_ms(torch, lambda: fa.launch_forward(q, k, v, True, sc, 0), iters=20),
                     time_ms(torch, lambda: fa.flash_forward_reference(
                         q, k, v, causal=True, scale=sc), iters=3, warmup=1),
                     time_ms(torch, lambda: F.scaled_dot_product_attention(
                         qg, kg, vg, is_causal=True), iters=20), fb["fwd"], err_o),
            fa.BWD: (time_ms(torch, lambda: fa.launch_backward(
                         q, k, v, o, lse, do, True, sc, 0), iters=20),
                     time_ms(torch, lambda: fa.flash_backward_reference(
                         q, k, v, o, lse, do, causal=True, scale=sc), iters=3, warmup=1),
                     time_ms(torch, lambda: torch.autograd.grad(
                         sdpa_out, (qg, kg, vg), dog, retain_graph=True), iters=20),
                     fb["bwd"], err_g)}
        for name, (ms, plain, sdpa, bd, err) in times.items():
            print(f"(c) TP {name} at B, L, H, D = {tuple(q.shape)} causal bf16 on {card}: "
                  f"{ms * 1e3:.1f} us per call ({bd['flops'] / ms / 1e9:.1f} TFLOP/s), plain "
                  f"{plain * 1e3:.1f} us, SDPA {sdpa * 1e3:.1f} us, bound "
                  f"{bd['bound_ms'] * 1e3:.1f} us ({bd['bound_by']}); max abs err {err:.2e}")
            out.setdefault(name, {})[f"h{h}"] = {
                "ms": ms, "plain_ms": plain, "library_ms": sdpa, "bound_ms": bd["bound_ms"],
                "bound_by": bd["bound_by"], "max_abs_err": err}
        del qkv, q, k, v, do, o, lse, ro, rlse, grads, want, qg, kg, vg, dog, sdpa_out
        torch.cuda.empty_cache()
    return out


def tp_serve_model(**kw) -> dict:
    """The TP serve's model spec at T 2: the phase's LM for serving
    (dense attention, ``TP_SERVE``'s positions, bf16)."""
    return dict(RING_MODEL, max_seq_len=TP_SERVE["max_seq_len"], dtype="bfloat16",
                attention="dense", tp_size=2, model_axis="model", **kw)


def tp_serve_prompts() -> list:
    """``TP_SERVE``'s prompts from seed 22: request 2 begins with request
    0's first ``prefix`` tokens (whole blocks)."""
    rng = np.random.default_rng(22)
    vocab = RING_MODEL["vocab_size"]
    out = [rng.integers(1, vocab, n).astype(np.int32) for n in TP_SERVE["lengths"]]
    out[2][:TP_SERVE["prefix"]] = out[0][:TP_SERVE["prefix"]]
    return out


def tp_serve_job() -> dict:
    """The ``"serve"`` job of the TP phase's spawn (``tools/serve_tp.py``):
    the ``TP_SERVE_CASES`` on the model axis of 2 ranks, each recorded
    (every decoded row) and with rank 0's replicated reference."""
    kw = dict(n_slots=TP_SERVE["slots"], block_len=TP_SERVE["block_len"],
              prefill_chunk=TP_SERVE["chunk"], cuda_graphs=False)
    prompts = tp_serve_prompts()
    cases = {name: dict(model=tp_serve_model(**model), kw=dict(kw, **extra), prompts=prompts,
                        max_new=TP_SERVE["max_new"], record=True, reference=True,
                        stagger=TP_SERVE["stagger"] if extra.get("prefix_cache") else 0)
             for name, (model, extra) in TP_SERVE_CASES.items()}
    return dict(task="serve", dp=1, mp=2, cases=cases)


def row_errs(got: dict, want: dict, streams: dict, ref_streams: dict):
    """``(first, rows, compared)``: the max abs error of each prompt's
    first-token logits row, and of every row while the two streams agree
    (row i is compared when tokens 0..i-1 agree), and how many rows that
    was."""
    first = rows = 0.0
    n = 0
    for rid, g in got.items():
        w = want[rid]
        first = max(first, (g[0] - w[0]).abs().max().item())
        for i in range(min(len(g), len(w))):
            if streams[rid][:i] != ref_streams[rid][:i]:
                break
            rows = max(rows, (g[i] - w[i]).abs().max().item())
            n += 1
    return first, rows, n


def tp_serve_checks(torch, card, per_rank, failures, on_card) -> dict:
    """Phase (c)'s checks of the TP serve cases: the ranks' streams and
    logits rows bit-equal, each case's rows against the one-card serve's
    (``TP_SERVE_TOL``; then the greedy match rate), a rank's pool bytes
    exactly half the one-card pool's, and on the card each rank's kernel 7
    and 8 launches: 12 (one a layer) for each chunk call and decode tick
    whose table routes it to that kernel. Returns the launches by kernel
    line name and the errors."""
    from pytorch_distributed_tpu_torch.ops import paged_flash
    from pytorch_distributed_tpu_torch.serving.kv_pool import kv_pool_dtype

    layers = RING_MODEL["num_layers"]
    launches, out = {}, {}
    for name, (model, extra) in TP_SERVE_CASES.items():
        res = [r[name] for r in per_rank]
        ref = res[0]["reference"]
        label = f"LM TP serve t2 {name}"
        equal = (all(r["streams"] == res[0]["streams"] for r in res)
                 and all(r["rows_digest"] == res[0]["rows_digest"] for r in res))
        first, rows, n = row_errs(res[0]["rows"], ref["rows"], res[0]["streams"],
                                  ref["streams"])
        match = match_rate(*([s[r] for r in sorted(s)] for s in (res[0]["streams"],
                                                                 ref["streams"])))
        share = res[0]["pool_bytes"] / ref["pool_bytes"]
        ok = (equal and first <= TP_SERVE_TOL["first"] and rows <= TP_SERVE_TOL["rows"]
              and all(r["pool_bytes"] * 2 == ref["pool_bytes"] for r in res))
        dt = kv_pool_dtype(extra["kv_dtype"]) if "kv_dtype" in extra else None
        keys = {k: (k if dt is None else paged_flash.variant(k, dt))
                for k in (paged_flash.SWEEP, paged_flash.SPLIT)}
        for r in res:
            want = {keys[paged_flash.SWEEP]: layers * (r["chunk_sweep"] + r["tick_sweep"]),
                    keys[paged_flash.SPLIT]: layers * (r["chunk_split"] + r["tick_split"])}
            got = {k: r["launches"].get(k, 0) for k in want}
            if dt is not None:  # every launch on the append route, none standalone
                got.update({f"append {k}": r["launches"].get(paged_flash.append_key(k, dt), 0)
                            for k in (paged_flash.SWEEP, paged_flash.SPLIT)})
                want.update({f"append {k}": want[keys[k]]
                             for k in (paged_flash.SWEEP, paged_flash.SPLIT)})
                got["standalone"] = r["launches"].get(paged_flash.variant(
                    paged_flash.QUANTIZE, dt), 0)
                want["standalone"] = 0
            want = {k: v * on_card for k, v in want.items()}
            launches_ok = got == want and (not on_card or r["ticks"] > 0)
            ok = ok and launches_ok
            for k in (paged_flash.SWEEP, paged_flash.SPLIT):
                launches[keys[k]] = launches.get(keys[k], 0) + got[keys[k]]
            if dt is not None:
                q = paged_flash.variant(paged_flash.QUANTIZE, dt)
                launches[q] = launches.get(q, 0) + got["append " + paged_flash.SWEEP] + got[
                    "append " + paged_flash.SPLIT]
        hits = res[0]["metrics"]["prefix_hits"]
        if extra.get("prefix_cache"):
            ok = ok and hits >= 1 and ref["metrics"]["prefix_hits"] == hits
        r0 = res[0]
        print(f"(c) {label} ({TP_SERVE['lengths']} prompt tokens, {TP_SERVE['max_new']} new, "
              f"eager) on {card}: ranks' streams and logits rows bit-equal {equal}; against "
              f"the one-card serve: first-token rows max abs err {first:.3e} (tol "
              f"{TP_SERVE_TOL['first']:g}), {n} rows while the streams agree {rows:.3e} (tol "
              f"{TP_SERVE_TOL['rows']:g}), greedy match {match:.3f}; a rank's pool "
              f"{r0['pool_bytes']} bytes = {share:.4f} of {ref['pool_bytes']}; "
              f"{r0['chunk_calls']} chunk calls ({r0['chunk_sweep']} sweep, "
              f"{r0['chunk_split']} split) and {r0['ticks']} ticks ({r0['tick_split']} split), "
              f"launches by rank {[r['launches'] for r in res]}"
              + (f"; prefix hits {hits}" if extra.get("prefix_cache") else "")
              + f"; tick p50 {r0['metrics']['tick_p50_s'] * 1e3:.1f} ms (staged: not a speed "
              f"figure) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        out[name] = dict(first=first, rows=rows, match=match, pool_share=share,
                         pool_bytes=r0["pool_bytes"])
    return {"launches": launches, "cases": out}


def head_slice(inp: dict, h: int, h_kv: int) -> dict:
    """A paged call's inputs at their first ``h`` query heads over their
    first ``h_kv`` KV heads (pools and any scales), each contiguous."""
    cut = {"q": h, "k_pool": h_kv, "v_pool": h_kv, "k_scale": h_kv, "v_scale": h_kv}
    return {k: v[:, :, :cut[k]].contiguous() if k in cut and v is not None else v
            for k, v in inp.items()}


def tp_paged_kernel_checks(torch, card, failures) -> dict:
    """Kernels 7 and 8 at the TP ranks' heads (``TP_PAGED_HEADS``, D 64,
    bf16 q): kernel 8 (the auto split) at decode (B 8, W 128) on bf16 and
    fp8 pools, kernel 7 (the sweep) at the prefill chunk (B 4 x C 32, W
    64), each against its plain version, then timed (CUDA events, the
    wrapper, 20 calls) beside its plain version, SDPA on gathered K/V (bf16
    pools; no PyTorch call reads fp8 K/V with per-row scales) and the
    bound."""
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.ops import paged_flash
    from pytorch_distributed_tpu_torch.ops.attention import paged_attention_reference

    out = {}
    # phase (d)'s inputs cut to the rank's heads: the same chains and
    # positions, so each bound is (d)'s at h / 12 of the heads
    full = {"decode": decode_inputs(torch, torch.bfloat16),
            "prefill chunk": prefill_inputs(torch, torch.bfloat16)}
    fp8 = quantized(torch, decode_inputs(torch, torch.float32, seed=5), "fp8")
    full["decode fp8"] = dict(fp8, q=fp8["q"].to(torch.bfloat16))
    for h, h_kv in TP_PAGED_HEADS:
        shapes = [("decode", paged_flash.SPLIT, None)]
        if h == 6:
            shapes.append(("prefill chunk", paged_flash.SWEEP, 1))
        if h_kv == h:
            shapes.append(("decode fp8", paged_flash.SPLIT, None))
        for shape, name, split_s in shapes:
            inp = head_slice(full[shape], h, h_kv)
            tag = f"h{h}" + (f"_hkv{h_kv}" if h_kv != h else "") + "_" + shape.replace(" ", "_")
            label = f"{name} at {shape}, H {h} over H_kv {h_kv}, D 64, bf16 q"
            ref = paged_attention_reference(**inp)
            err = check_abs(torch, failures, f"TP {label}",
                            paged_flash.paged_flash_attention(**inp, split_s=split_s), ref,
                            BF16_TOL)
            bd = bound(inp)
            ms = time_ms(torch, lambda: paged_flash.paged_flash_attention(
                **inp, split_s=split_s), iters=20)
            plain = time_ms(torch, lambda: paged_attention_reference(**inp), iters=20)
            lib = None
            if "k_scale" not in inp:
                qg, kg, vg, mask = gathered(torch, inp)
                lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qg, kg, vg, attn_mask=mask), iters=20)
                del qg, kg, vg, mask
            key = name if "k_scale" not in inp else paged_flash.variant(
                name, inp["k_pool"].dtype)
            print(f"(c) TP {label} on {card}: {ms * 1e3:.1f} us per call, plain "
                  f"{plain * 1e3:.1f} us, SDPA on gathered K/V "
                  f"{'none' if lib is None else f'{lib * 1e3:.1f} us'}, bound "
                  f"{bd['bound_ms'] * 1e3:.2f} us ({bd['bound_by']}: {bd['bytes'] / 1e6:.2f} MB)"
                  f"; max abs err {err:.2e}")
            out.setdefault(key, {})[tag] = {
                "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bd["bound_ms"],
                "bound_by": bd["bound_by"], "max_abs_err": err}
        torch.cuda.empty_cache()
    return out


def tp_runs(torch, card, tmp, dev="cuda", recipes=True, cpu_ranks=2, serve=None,
            train=True) -> dict:
    """Phase (c) for Megatron tensor parallelism (``TP``), the ranks of
    ``tp_ranks`` spawned once through ``tools/parallel_check.py``. On one
    card (2 ranks over gloo): T 2 with MHA, with vocab parallelism and
    with GQA + RoPE, each step's loss and grad norm against the one-card
    replicated step from the same weights (``TP_RTOL``; rank 0 runs it
    after each case, ``tools/parallel_check.py``'s ``reference``), every parameter
    gathered to its global leaf and its update against the one-card one
    (``TP_UPDATE_RTOL``), the validation loss, 12 + 12 flash launches a
    step on each rank, a rank's parameter and optimizer bytes against the
    one-card state's (``predicted_share``); the recipe's
    ``--model-parallel 2`` refused. On 4 cards over NCCL: T 2 x DP 2
    (also vocab-parallel and with FSDP), T 4 (also vocab-parallel) and
    replicated DP 4, losses and grad norms against the one-card step, step
    p50 against DP 4's, the state shares; then, with ``recipes``, the
    recipe at ``--model-parallel 2``, ``4`` and ``2 --fsdp`` against its
    one-card run. With ``serve`` (None: on a card) and 2 ranks the same
    spawn also runs the TP serve's cases (``tp_serve_job``, checked by
    ``tp_serve_checks``); ``train=False`` leaves out the training cases
    and the recipes. Then (on a card) kernels 4 and 5 at the TP shapes
    (``tp_kernel_checks``) and kernels 7 and 8 at the serve's
    (``tp_paged_kernel_checks``). Returns the launches for the kernels
    line and the errors. With ``dev="cpu"`` (a rehearsal) ``cpu_ranks``
    ranks (2, or 4 for the 4-card grids) meet over gloo on the CPU and the
    kernels are not timed."""
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_tpu_torch.tools import parallel_check
    from pytorch_distributed_tpu_torch.train import lm_collate

    t_phase = time.perf_counter()
    on_card = 1 if dev == "cuda" else 0
    cards = torch.cuda.device_count() if dev == "cuda" else 0
    ranks, backend = tp_ranks(cards) if dev == "cuda" else (cpu_ranks, "gloo")
    four = ranks == 4
    where = (f"{ranks} ranks on {ranks} cards" if backend == "nccl" else
             f"{ranks} ranks on 1 card, every tp_copy / tp_reduce staged through the host")
    print(f"(c) tensor parallelism: backend {backend}, {where}")
    seq, steps, n_layers = TP["seq"], TP["steps"], RING_MODEL["num_layers"]
    bsz = TP["batch_4"] if four else TP["batch"]
    vocab = RING_MODEL["vocab_size"]
    rng = np.random.default_rng(13)
    batches = [lm_collate(list(rng.integers(1, vocab, (bsz, seq)).astype(np.int32)))
               for _ in range(steps)]
    val = [lm_collate(list(rng.integers(1, vocab, (bsz, seq)).astype(np.int32)))]
    failures = []
    staged = "-staged: not a speed figure" if backend == "gloo" else ""
    # every case against the one-card step that rank 0 runs after it from
    # the same weights on the global batches (``reference``)
    lm = dict(task="lm", batches=batches, val_batches=val, params_out=False)
    case = dict(mode="replicated", clip=1.0, reference=True)
    if four:
        jobs = {
            "t2 x dp2": dict(lm, dp=2, mp=2, cases={
                "mha": dict(case, model=tp_model(2)),
                "vocab": dict(case, model=tp_model(2, vocab_parallel=True)),
                "fsdp": dict(case, model=tp_model(2), mode="fsdp")}),
            "t4": dict(lm, dp=1, mp=4, cases={
                "mha": dict(case, model=tp_model(4)),
                "vocab": dict(case, model=tp_model(4, vocab_parallel=True))}),
            "dp4": dict(lm, dp=4, mp=1, cases={"replicated": dict(case, model=tp_model(1))})}
    else:
        jobs = {"t2": dict(lm, dp=1, mp=ranks, cases={
            "mha": dict(case, model=tp_model(2)),
            "vocab": dict(case, model=tp_model(2, vocab_parallel=True)),
            "gqa": dict(case, model=tp_model(2, **TP_GQA))})}
    if not train:
        jobs, recipes = {}, False
    serve = (dev == "cuda") if serve is None else serve
    if serve and ranks == 2:
        jobs["serve"] = tp_serve_job()
    job = dict(task="many", backend=backend, device=dev, timeout_s=TP["timeout_s"],
               schedule=PARALLEL_SCHEDULE, dp=ranks, rendezvous=f"file://{tmp}/rendezvous-tp",
               out=f"{tmp}/tp", jobs=jobs)
    empty_cache(torch, dev)
    t0 = time.perf_counter()
    parallel_check.run(job, ranks)
    results = parallel_check.load(job)
    print(f"(c) {ranks} ranks: {time.perf_counter() - t0:.1f}s spawned, built and run")

    tol = {k: tuple(v) for k, v in TP_RTOL.items()}
    errs, shares, launches, step_p50 = {}, {}, [], {}
    runs = [(j, c) for j in jobs if j != "serve" for c in jobs[j]["cases"]]
    for j, c in runs:
        per_rank = [r[j][c] for r in results]
        t = jobs[j].get("mp", 1)
        ref = per_rank[0]["reference"]
        m = per_rank[0]["metrics"]
        step_p50[f"{j} {c}"] = float(np.median(m["step_s"]))
        label = f"LM TP {j} {c}" if t > 1 else f"LM {j} {c}"
        print(f"(c) {label}, {steps} steps of B={bsz // jobs[j].get('dp', 1)} a replica x "
              f"L={seq} bf16 on {card}: losses {[round(x, 5) for x in m['loss']]}, grad norms "
              f"{[round(x, 4) for x in m['grad_norm']]}; step p50 "
              f"{step_p50[f'{j} {c}'] * 1e3:.1f} ms ({backend}{staged}); parameter + optimizer "
              f"bytes per rank {[x['state_bytes'] for x in per_rank]}, peak memory "
              f"{[round(x['peak_gib'], 2) for x in per_rank]} GiB")
        errs[f"{j} {c}"] = step_errs(failures, m, ref["metrics"],
                                     f"{label} vs the one-card step", tol)
        if t > 1:
            want = [n_layers, n_layers]  # every layer once a step, at H/T heads
            got = [x["metrics"]["launches"] for x in per_rank]
            ok = all(s_ == [w * on_card for w in want] for rank in got for s_ in rank)
            print(f"(c) {label}: flash forward / backward launches a step per rank "
                  f"{[rank[0] for rank in got]} (want {[w * on_card for w in want]} at "
                  f"H {RING_MODEL['num_heads'] // t}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{label} launches")
            launches += got
            share = shares[f"{j} {c}"] = per_rank[0]["state_bytes"] / ref["state_bytes"]
            if c in ("mha", "vocab"):
                want_share = predicted_share(torch, jobs[j]["cases"][c]["model"])
                ok = abs(share - want_share) <= TP_SHARE_TOL
                print(f"(c) {label}: a rank's parameter + optimizer bytes / one card's "
                      f"{share:.4f} (predicted {want_share:.4f} from the parameter counts, "
                      f"tol {TP_SHARE_TOL:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{label} state share")
            else:
                print(f"(c) {label}: a rank's parameter + optimizer bytes / one card's "
                      f"{share:.4f}")
        # the validation batch after the steps
        v, rv = per_rank[0]["val"], ref["val"]
        vl, rl = (x["loss_sum"] / max(x["tokens"], 1) for x in (v, rv))
        ok = v["tokens"] == rv["tokens"] > 0 and rel_err(vl, rl) <= tol["loss"][-1]
        print(f"(c) {label} validation vs the one-card state: loss {vl:.5f} vs {rl:.5f} "
              f"(relative error {rel_err(vl, rl):.2e}, tol {tol['loss'][-1]:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} validation")
        if t > 1:
            upd = ref["update"]
            worst = max(upd, key=upd.get)
            median = float(np.median(list(upd.values())))
            ok = (ref["leaves_ok"] and median <= TP_UPDATE_RTOL["median"]
                  and upd[worst] <= TP_UPDATE_RTOL["worst"])
            errs[f"{j} {c}"].update(update=upd[worst], update_median=median)
            print(f"(c) {label}: every parameter gathered to its global leaf, its update "
                  f"over {steps} steps against the one-card one: median {median:.3f}, worst "
                  f"{worst} {upd[worst]:.3f} (tol {TP_UPDATE_RTOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{label} parameters")
    served = {}
    if "serve" in jobs:
        served = tp_serve_checks(torch, card, [r["serve"] for r in results], failures, on_card)
    del results
    if four:
        base = step_p50["dp4 replicated"]
        print(f"(c) step p50 over {ranks} {backend} ranks on {card}: "
              + ", ".join(f"{k} {v * 1e3:.1f} ms ({v / base:.2f}x DP 4)"
                          for k, v in step_p50.items()))

    # ---- the recipe: refused on one card, against its one-card run on 4 ----
    from pytorch_distributed_tpu_torch.recipes import lm_pretrain

    recipe = {}
    extra = ["--device", "cpu", "--tiny"] if dev == "cpu" else ["--synthetic"]
    flag_sets = ((["--model-parallel", "2"], ["--model-parallel", "4"],
                  ["--model-parallel", "2", "--fsdp"]) if four else
                 (["--model-parallel", "2"],))
    for flags in flag_sets if recipes else ():
        label = " ".join(flags)
        t = int(flags[1])
        refused = dev == "cuda" and cards < t
        dp = max(cards, 1) // t if dev == "cuda" else 1
        base = [*extra, "--epochs", "1", "--log-every", "1"]
        argv = [*base, *flags, "--steps", str(TP["recipe_steps"]), "--batch-size",
                str(TP["recipe_batch"]), "--save-dir", os.path.join(tmp, "r" + label)]
        t0 = time.perf_counter()
        try:
            summary, error = lm_pretrain.main(argv), ""
        except SystemExit as e:
            summary, error = {}, str(e)
        secs = time.perf_counter() - t0
        empty_cache(torch, dev)
        if refused:
            ok = "needs a card per rank" in error
            print(f"(c) recipes/lm_pretrain.py {label}: refused on {cards} card: "
                  f"{error[:60]}... {'ok' if ok else 'FAIL'}")
        else:
            # the same global batches on one device: the replicas' rows in
            # one batch, the same sequences
            ref_argv = [*base, "--steps", str(TP["recipe_steps"] // dp), "--batch-size",
                        str(TP["recipe_batch"] * dp), "--save-dir",
                        os.path.join(tmp, "ref" + label)]
            want = lm_pretrain.train(lm_pretrain._parse(ref_argv), device=dev)
            empty_cache(torch, dev)
            err = rel_err(summary.get("loss", float("nan")), want["loss"])
            ok = not error and err <= tol["loss"][0]
            print(f"(c) recipes/lm_pretrain.py {label}: validation loss "
                  f"{summary.get('loss')} vs {want['loss']} on one device (relative error "
                  f"{err:.2e}, tol {tol['loss'][0]:g}) in {secs:.1f}s{error} "
                  f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"lm_pretrain {label}: {error}")
        recipe[label] = {"seconds": secs, "loss": summary.get("loss"), "error": error}

    kernels = tp_kernel_checks(torch, card, failures) if dev == "cuda" and train else {}
    paged = tp_paged_kernel_checks(torch, card, failures) if dev == "cuda" and serve else {}
    wall = time.perf_counter() - t_phase
    print(f"(c) tensor-parallel phase: {wall:.1f} s")
    if failures:
        raise SystemExit(f"chip_smoke: tensor parallelism failed: {failures}")
    flash = {fa.FWD: sum(s_[0] for rank in launches for s_ in rank),
             fa.BWD: sum(s_[1] for rank in launches for s_ in rank)}
    return {"flash_launches": flash, "errs": errs, "state_share": shares,
            "step_p50": step_p50, "recipe": recipe, "kernels": kernels, "wall_s": wall,
            "serve_launches": served.get("launches", {}), "serve": served.get("cases", {}),
            "paged_kernels": paged}


def parallel_and_tp(torch, card, tmp, dev="cuda") -> dict:
    """``parallel_runs`` and then ``tp_runs``, in one (spawned) process."""
    return {"parallel": parallel_runs(torch, card, tmp, dev),
            "tp": tp_runs(torch, card, tmp, dev)}


def dp_timing(torch, card, tmp, ranks, dev="cuda") -> dict:
    """The DP phase's NCCL times: ``tools/dp_check.py``'s ``"timing"`` task
    on 1, 2 and 4 ranks (up to ``ranks``) and back. Returns, by model and
    rank count, each run's rank-0 step p50, img/s and every rank's device
    split."""
    from pytorch_distributed_tpu_torch.tools import dp_check

    # 1, 2, 4 cards, then back (4, 2, 1): a drift of the card or the host
    # over the run shows as two readings of one count that disagree
    counts = [n for n in (1, 2, 4) if n <= ranks]
    timing = {}
    for run, n in enumerate(counts + counts[::-1]):
        job = dict(task="timing", backend="nccl",
                   rendezvous=f"file://{tmp}/rendezvous-time{run}", out=f"{tmp}/time{run}",
                   device=dev, timeout_s=DP["timeout_s"], size=DP_SIZE,
                   warmup=DP_TIMING["warmup"], steps=DP_TIMING["steps"],
                   profiled=DP_TIMING["profiled"],
                   models={"fused bf16": dict(model=dict(DP_MODEL, dtype="bfloat16", fused=True),
                                              batch=DP_TIMING["fused"]),
                           "plain fp32": dict(model=dict(DP_MODEL, dtype="float32"),
                                              batch=DP_TIMING["plain"])})
        dp_check.run(job, n)
        by_rank = dp_check.load(job, n)
        for name in by_rank[0]:
            rs = [r[name] for r in by_rank]
            p50 = float(np.median(rs[0]["step_s"]))
            timing.setdefault(name, {}).setdefault(n, []).append(dict(
                p50_ms=p50 * 1e3, img_s=n * rs[0]["batch"] / p50,
                steps_ms=[round(x * 1e3, 2) for x in rs[0]["step_s"]],
                busy=[r["busy"] for r in rs], nccl_ms=[r["nccl_ms"] for r in rs],
                compute_ms=[r["compute_ms"] for r in rs], peak_gib=rs[0]["peak_gib"]))
    for name, by_n in timing.items():
        one = float(np.mean([t["img_s"] for t in by_n[1]]))
        for n, runs in by_n.items():
            for i, t in enumerate(runs):
                print(f"(c) DP timing {name}, {n} card(s) over NCCL, "
                      f"{'first' if i == 0 else 'second'} run, B={DP_TIMING[name.split()[0]]} a "
                      f"card on {card}: step p50 {t['p50_ms']:.2f} ms (rank 0's steps "
                      f"{t['steps_ms']} ms), {t['img_s']:.1f} img/s, {t['img_s'] / one:.3f}x "
                      f"one card (the mean of its two runs); profiled, by rank: busy share "
                      f"{[round(x, 3) for x in t['busy']]}, device ms a step under NCCL kernels "
                      f"{[round(x, 2) for x in t['nccl_ms']]} and under the others "
                      f"{[round(x, 2) for x in t['compute_ms']]}; peak memory "
                      f"{t['peak_gib']:.1f} GiB")
    return timing


# kernels one call of each tail function launches: the reduction and its
# merge; dz alone
TAIL_LAUNCHES = {"moments": 2, "tail_bwd_reduce": 2, "tail_bwd_dz": 1}
TAIL_KERNEL_NAMES = {
    "moments": "tail_reduce_wgmma_kernel<false, ...> + tail_merge_kernel<false>",
    "tail_bwd_reduce": "tail_reduce_wgmma_kernel<true, ...> + tail_merge_kernel<true>",
    "tail_bwd_dz": "tail_dz_wgmma_kernel"}


def tail_shapes():
    """(label, (B, H, F), kernels) of phase (d): the four stage shapes for
    all three tail kernels, the four downsample inputs for moments."""
    return ([(f"stage {i + 1}", shape, ("moments", "tail_bwd_reduce", "tail_bwd_dz"))
             for i, shape in enumerate(TAIL_STAGES)]
            + [(f"downsample input of stage {i + 1}", shape, ("moments",))
               for i, shape in enumerate(TAIL_DOWNSAMPLE)])


def time_tail_kernels(torch, card, dev="cuda") -> dict:
    """Phase (d) for the tail kernels at every shape of ``tail_shapes``:
    each wrapper by CUDA events, its kernels by their device time
    (``kernel_device_ms``: the reduction and its merge for moments and
    tail_bwd_reduce, the merge also alone), its plain version and the cuBLAS spelling of the XLA
    step (no single PyTorch call computes any of the three), beside the
    bound. Returns the kernels line's entries: stage 1's numbers, with every
    shape's under "stages"."""
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

    bf16 = torch.bfloat16
    spelling = {bt.MOMENTS: "z2d.T @ z2d, z2d.sum(0): 2 calls",
                bt.BWD_REDUCE: "torch.where(out > 0, g, 0), z2d.T @ gp, gp.sum(0): 4 kernels",
                bt.BWD_DZ: "torch.addmm(dmn, torch.cat([gp, z], 1), torch.cat([wa, c]) in "
                           "bf16): 4 calls"}
    stages = {name: {} for name in TAIL_LAUNCHES}
    for label, (b, hw, f), names in tail_shapes():
        z, g, out, wa, c, dmn = tail_inputs(torch, bf16, b, hw, f, seed=11, dev=dev)
        e = 4 * f
        z2, g2, o2 = (x.view(-1, x.shape[-1]) for x in (z, g, out))
        gp = bt.tail_bwd_reduce_reference(z, g, out)[0]
        gp2 = gp.view(-1, e)

        def reduce_spelling():
            q = torch.where(o2 > 0, g2, 0)
            return z2.T @ q, q.sum(0, dtype=torch.float32)

        runs = {
            bt.MOMENTS: (lambda: bt.moments(z), lambda: bt.moments_reference(z),
                         lambda: (z2.T @ z2, z2.sum(0, dtype=torch.float32))),
            bt.BWD_REDUCE: (lambda: bt.tail_bwd_reduce(z, g, out),
                            lambda: bt.tail_bwd_reduce_reference(z, g, out), reduce_spelling),
            bt.BWD_DZ: (lambda: bt.tail_bwd_dz(gp, z, wa, c, dmn),
                        lambda: bt.tail_bwd_dz_reference(gp, z, wa, c, dmn),
                        lambda: torch.addmm(dmn.to(bf16), torch.cat([gp2, z2], 1),
                                            torch.cat([wa, c]).to(bf16))),
        }
        for name in names:
            fns = runs[name]
            t_k, t_p, t_s = (time_ms(torch, fn, iters=20) for fn in fns)
            match = {name: (lambda k: bt.kernel_of(k) == name, TAIL_LAUNCHES[name])}
            if name != bt.BWD_DZ:
                match["merge"] = (lambda k: "tail_merge" in k, 1)
            dev_ms = kernel_device_ms(torch, fns[0], match)
            t_dev = dev_ms[name]
            bd = tail_bound(name, z2.shape[0], f, e, 2, bf16)
            stages[name][label] = {"ms": t_k, "device_ms": t_dev, "plain_ms": t_p,
                                   "spelling_ms": t_s, "bound_ms": bd["bound_ms"],
                                   "bound_by": bd["bound_by"]}
            merge = ""
            if name != bt.BWD_DZ:
                stages[name][label]["merge_ms"] = dev_ms["merge"]
                merge = f", the merge {dev_ms['merge'] * 1e3:.1f} us of it"
            print(f"(d) {name} at {label} z [{b},{hw},{hw},{f}] E={e} bf16 on {card}: "
                  f"{t_k * 1e3:.1f} us per call (its kernels {t_dev * 1e3:.1f} us device time"
                  f"{merge}), "
                  f"plain {t_p * 1e3:.1f} us, cuBLAS spelling {t_s * 1e3:.1f} us "
                  f"({spelling[name]}), bound {bd['bound_ms'] * 1e3:.1f} us ({bd['bound_by']}: "
                  f"{bd['bytes'] / 1e6:.1f} MB, {bd['flops'] / 1e9:.2f} GFLOP), "
                  f"{bd['bound_ms'] / t_k:.3f} of the bound")
        del runs, z, g, out, gp, gp2, z2, g2, o2
        empty_cache(torch, dev)
    entries = {}
    for name, by_shape in stages.items():
        first = by_shape["stage 1"]
        entries[name] = {"ms": first["ms"], "plain_ms": first["plain_ms"],
                         "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                         "library_ms": None, "spelling_ms": first["spelling_ms"],
                         "kernel": TAIL_KERNEL_NAMES[name], "device_ms": first["device_ms"],
                         "stages": by_shape}
    return entries


def profiled_busy(torch, cfg, state, prompts, max_new, kw) -> float:
    """The device's busy share of one warmed-up serve of ``prompts``
    (``Scheduler(**kw)``, ``warmup(background=False)`` first; driven by
    ``step()``, or by ``lagged_drain`` where ``kw["lagged"]``; or, where
    ``kw["fleet"]`` holds ``FleetRouter`` arguments, a fleet of such
    replicas, the requests in 4 sessions): the union of the kernels'
    intervals in a ``torch.profiler`` trace of the CUDA activity alone, over
    the serve's wall."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_tpu_torch.fleet import FleetRouter
    from pytorch_distributed_tpu_torch.serving import Scheduler
    from pytorch_distributed_tpu_torch.tools.profile_serve import busy_share

    kw = dict(kw)
    lagged = kw.pop("lagged", False)
    fleet = kw.pop("fleet", None)
    if fleet is not None:
        sched = FleetRouter(cfg, state, gather_impl="kernel", **fleet, **kw)
        sched.warmup()
        for i, q in enumerate(prompts):
            sched.submit(q, max_new, session=i % 4)
    else:
        sched = Scheduler(cfg, state, gather_impl="kernel", **kw)
        sched.warmup(background=False)
        for q in prompts:
            sched.submit(q, max_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lagged_drain(sched) if lagged else sched.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if fleet is not None:
        sched.close()
    return busy_share(prof, wall * 1e6)


#: the profiled paths that take a process of their own (``busy_shares``)
BUSY_APART = ("eager", "fleet_async")


def _busy_child(cfg, prompts, max_new, kws_by_path, weights) -> dict:
    """``profiled_busy`` of each serve of ``kws_by_path`` in this (spawned)
    process, in order, on the seed-0 weights main saved to ``weights``
    (memory-mapped: a full-width draw takes seconds of host time)."""
    import torch

    state = torch.load(weights, mmap=True)
    return {path: [profiled_busy(torch, cfg, state, prompts, max_new, kw) for kw in kws]
            for path, kws in kws_by_path.items()}


def busy_shares(cfg, prompts, max_new, kws_by_path, weights) -> dict:
    """``profiled_busy`` of the serves of each path (``{path: [kw, ...]}``):
    each path of ``BUSY_APART`` in a process of its own, then the other
    paths, which replay graphs, in one more, in the order given; all away
    from phase (d)'s device times. Eager and graph serves profiled in turns
    in one process (eager, graphs, eager, graphs) left that process's later
    traces short of launches, every one; after the other graph paths in one
    process the lagged fleet read well above its share in a process of its
    own, the others within the spread of a process each (PERF.md §6). Each
    process pays its imports, its weights and the profiler's first
    trace."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    groups = [{p: k} for p, k in kws_by_path.items() if p in BUSY_APART]
    groups.append({p: k for p, k in kws_by_path.items() if p not in BUSY_APART})
    ctx = multiprocessing.get_context("spawn")
    out = {}
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx, max_tasks_per_child=1) as ex:
        for f in [ex.submit(_busy_child, cfg, prompts, max_new, g, weights)
                  for g in groups if g]:
            out.update(f.result())
    return {path: out[path] for path in kws_by_path}


def graph_runs(torch, card, serve, cfg, state, prompts, serve_kw, *, n_blocks, weights,
               dev="cuda") -> dict:
    """(c) the serve's CUDA graphs. The 16 requests on bf16 pools and on
    fp8 pools (``n_blocks`` of them) through the eager path
    (``cuda_graphs=False``) and through the graphs, each after
    ``warmup(background=False)`` (``serve(warm=True)``: no capture, no cold
    request, the registry covering the engine): greedy streams and every
    launch counter bit-equal; tick p50, tok/s, TTFT and the busy share of
    a profiled serve of each path (``busy_shares``). The warmup's capture
    seconds a program and in all, the graphs and their pool's bytes. A
    serve at temperature 0.8, top-k 50, from a seeded generator: it
    completes after a warmup (the generator registered with the decode
    graph), and two replays of its decode tick on the same logits draw
    differently; the sampler draws as ``torch.multinomial`` on the card.
    Fails the run on any difference. The bf16 serve's busy share is also
    taken by the lagged loop (``lagged_drain``), a third path, for
    ``lifecycle_runs``, and by a fleet of two replicas under each loop
    (``fleet_busy``, for ``fleet_line``), in processes that load
    ``weights``, main's saved copy of ``state``."""
    from pytorch_distributed_tpu_torch.compilecache import serving_registry
    from pytorch_distributed_tpu_torch.models.generate import _sample
    from pytorch_distributed_tpu_torch.ops.attention import NEG_INF
    from pytorch_distributed_tpu_torch.serving import Scheduler

    max_new = 32
    kinds = (("bf16", {}), ("fp8", {"kv_dtype": "fp8", "n_blocks": n_blocks}))
    busy = busy_shares(cfg, prompts, max_new, {
        **{path: [{**serve_kw, **extra, "cuda_graphs": path == "graphs"}
                  for _, extra in kinds] for path in ("eager", "graphs")},
        "lagged": [{**serve_kw, "cuda_graphs": True, "lagged": True}],
        **{path: [dict(serve_kw, fleet=dict(n_replicas=2, async_host=path == "fleet_async"))]
           for path in ("fleet_sync", "fleet_async")}}, weights)
    out = {}
    for i, (kind, extra) in enumerate(kinds):
        runs = {}
        for path in ("eager", "graphs"):
            sched, streams, m, wall, launches = serve(
                f"{kind} pools, {path}, warmed up", prompts, warm=True,
                cuda_graphs=path == "graphs", **extra)
            runs[path] = {"streams": streams, "launches": launches, "wall_s": wall,
                          "tok_per_s": m["tokens_out"] / wall, "tick_p50_s": m["tick_p50_s"],
                          "ttft_p50_s": m["ttft_p50_s"], "ttft_p95_s": m["ttft_p95_s"],
                          "graphs": sched.engine.captures}
            if path == "graphs":
                runs[path]["pool_bytes"] = sched.engine.graph_pool_bytes()
            del sched
            torch.cuda.empty_cache()
        for path in ("eager", "graphs"):
            runs[path]["busy"] = busy[path][i]
        e, g = runs["eager"], runs["graphs"]
        print(f"(c) {kind} pools on {card}, eager vs CUDA graphs (both warmed up): tick p50 "
              f"{e['tick_p50_s'] * 1e3:.3f} vs {g['tick_p50_s'] * 1e3:.3f} ms, "
              f"{e['tok_per_s']:.1f} vs {g['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{e['ttft_p50_s'] * 1e3:.1f} vs {g['ttft_p50_s'] * 1e3:.1f} ms, p95 "
              f"{e['ttft_p95_s'] * 1e3:.1f} vs {g['ttft_p95_s'] * 1e3:.1f} ms, busy share "
              f"{e['busy']:.3f} vs {g['busy']:.3f}; {g['graphs']} graphs, pool "
              f"{g['pool_bytes']} bytes")
        if e["streams"] != g["streams"] or e["launches"] != g["launches"]:
            raise SystemExit(f"chip_smoke: {kind} pools: the graphs' serve differs from the "
                             f"eager one (streams equal: {e['streams'] == g['streams']}; "
                             f"launches {e['launches']} vs {g['launches']})")
        out[kind] = {k: v for path, r in runs.items() for k, v in
                     ((f"{path}_{name}", x) for name, x in r.items()
                      if name not in ("streams", "launches"))}
    out["bf16"]["lagged_busy"] = busy["lagged"][0]
    out["fleet_busy"] = {path: busy[path][0] for path in ("fleet_sync", "fleet_async")}

    # the warmup itself, its captures program by program
    sched = Scheduler(cfg, state, gather_impl="kernel", **serve_kw)
    runner = sched.warmup(background=False)
    summary = runner.summary()
    reg = serving_registry(sched.engine)
    per = {r["program"]: r["backend_compile_s"] for r in runner.records}
    out["warmup"] = {"programs": summary["programs"], "total_s": summary["total_s"],
                     "capture_s": summary["backend_compile_s"],
                     "graphs": sched.engine.captures,
                     "pool_bytes": sched.engine.graph_pool_bytes(),
                     "capture_s_min": min(per.values()), "capture_s_max": max(per.values()),
                     "decode_capture_s": per[sched.engine.DECODE_PROGRAM]}
    print(f"(c) warmup on {card}: {summary['programs']} programs ({len(reg)} in the "
          f"registry; the buckets narrower than one chunk are never reached and not "
          f"captured), {sched.engine.captures} graphs in {summary['total_s']:.2f}s, "
          f"{summary['backend_compile_s']:.2f}s of it capture (a program "
          f"{out['warmup']['capture_s_min'] * 1e3:.1f}-{out['warmup']['capture_s_max'] * 1e3:.1f}"
          f" ms, the decode tick {out['warmup']['decode_capture_s'] * 1e3:.1f} ms); graph pool "
          f"{out['warmup']['pool_bytes']} bytes; per program {per}")
    names = sched.engine.compiled_program_names()
    reg.assert_covers(names)
    if (summary["programs"] != len(reg) or sched.engine.DECODE_PROGRAM not in names
            or sched.engine.captures != (len(names) if sched.engine.cuda_graphs else 0)):
        raise SystemExit(f"chip_smoke: warmup of {len(reg)} registry programs made "
                         f"{summary['programs']} records, {sched.engine.captures} graphs, "
                         f"programs {names}")
    del sched, runner
    torch.cuda.empty_cache()

    # sampling: the generator registered with the decode graph
    sched, streams, m, _, _ = serve("bf16 pools, temperature 0.8, top-k 50, seed 7, warmed up",
                                    prompts, warm=True, temperature=0.8, top_k=50, seed=7)
    eng = sched.engine
    idle = (np.zeros(eng.n_slots, np.int64), np.zeros(eng.n_slots, bool))
    first, second = eng.decode(*idle)[0], eng.decode(*idle)[0]  # the logits stay as they are
    z = torch.randn(8, cfg.vocab_size, device=dev,
                    generator=torch.Generator(dev).manual_seed(3)) * 4
    ours = _sample(z, 0.8, 50, torch.Generator(dev).manual_seed(5))
    z = z / 0.8
    z = z.masked_fill(z < torch.sort(z, dim=-1).values[:, -50][:, None], NEG_INF)
    theirs = torch.multinomial(torch.softmax(z, dim=-1), 1,
                               generator=torch.Generator(dev).manual_seed(5))[:, 0]
    print(f"(c) sampled serve: {m['tokens_out']} tokens, {m['graphs']} graphs; two replays "
          f"of the decode tick on the same logits drew {first.tolist()} and {second.tolist()}; "
          f"the sampler against torch.multinomial on the card: {ours.tolist()} vs "
          f"{theirs.tolist()}")
    if np.array_equal(first, second) or not torch.equal(ours.long(), theirs):
        raise SystemExit("chip_smoke: the captured sampling tick replayed frozen draws, or "
                         "the sampler drew otherwise than torch.multinomial")
    out["sampled"] = {"tokens": m["tokens_out"], "graphs": m["graphs"]}
    del sched, eng
    torch.cuda.empty_cache()
    return out


def one_hot_moe(torch, layer, x):
    """``layer`` (a ``MoEMLP``) on ``x [B, L, D]`` spelt as the JAX
    ``MoEMLP`` spells it, independently of the port's index tensors:
    ``topk_dispatch``'s one-hot dispatch and combine ``[T, E, C]`` (the top
    ``k`` by a stable descending sort, positions by a cumulative sum over
    the tokens a choice rank, capacity filled rank by rank), the expert
    buffers and the output by einsums in the compute dtype. Returns the
    output, the weighted aux loss, the drop share and the dispatch mask."""
    import math

    b, l, d = x.shape
    t, e, k, dt = b * l, layer.n_experts, layer.top_k, layer.dtype
    xf = x.reshape(t, d)
    probs = torch.softmax(layer.router(xf.float()), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = order.values[:, :k], order.indices[:, :k]
    gates = topv if k == 1 else topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    cap = max(math.ceil(layer.capacity_factor * k * t / e), 1)
    experts = torch.arange(e, device=x.device)
    places = torch.arange(cap, device=x.device)
    dispatch = torch.zeros((t, e, cap), device=x.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros(e, device=x.device)
    for r in range(k):
        onehot = (topi[:, r, None] == experts).float()  # [T, E]
        pos = ((torch.cumsum(onehot, 0) - 1.0 + counts) * onehot).sum(-1).long()
        kept = (pos < cap).float()
        at = (pos[:, None] == places).float()  # [T, C]; none past capacity
        disp = onehot[:, :, None] * at[:, None, :] * kept[:, None, None]
        dispatch += disp
        combine += disp * gates[:, r, None, None]
        counts += (onehot * kept[:, None]).sum(0)
        del onehot, at, disp
    first = (topi[:, 0, None] == experts).float()
    aux = layer.aux_loss_weight * e * torch.sum(first.mean(0) * probs.mean(0))
    dropped = (dispatch.sum((1, 2)) == 0).float().mean()
    xe = torch.einsum("tec,td->ecd", dispatch.to(dt), xf.to(dt))
    h = torch.nn.functional.gelu(torch.einsum("ecd,edf->ecf", xe, layer.w_up.to(dt)),
                                 approximate="tanh")
    ye = torch.einsum("ecf,efd->ecd", h, layer.w_down.to(dt))
    out = torch.einsum("tec,ecd->td", combine.to(dt), ye).reshape(b, l, d)
    return out, aux, dropped, dispatch > 0


def moe_against_one_hot(torch, cfg, params, tokens, dev="cuda") -> dict:
    """The first MoE layer of the LM ``cfg`` with weights ``params``, on
    its input from a forward of ``tokens [B, L]``: the port's layer (index
    tensors, ``index_copy`` / ``index_select``) against ``one_hot_moe``.
    The dispatch the port's routes give (rebuilt to ``[T, E, C]``) must
    equal the one-hot one; the drop share equal; the aux loss within
    1e-5 relative (the same fp32 sums in another order); the output
    within two bf16 units in the last place of its largest magnitude (the
    expert buffers are the same bits; the combine rounds the same products
    once, or for top-2 a sum of two, where a split-K product may round a
    partial first). A misrouted token moves its row by its own size."""
    from pytorch_distributed_tpu_torch.models.moe import capacity_of, moe_layers, topk_routes

    model = plain_model(torch, cfg, params, dev)
    layer = next(moe_layers(model))
    seen = []
    hook = layer.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    with torch.no_grad():
        model(tokens, return_hidden=True)
        hook.remove()
        x = seen[0]
        got = layer(x).float()
        want, aux, dropped, dispatch = one_hot_moe(torch, layer, x)
        t = x.shape[0] * x.shape[1]
        cap = capacity_of(layer.capacity_factor, layer.top_k, t, layer.n_experts)
        routes = topk_routes(layer.router(x.reshape(t, -1).float()), cap, layer.top_k)
        ours = torch.zeros((t, layer.n_experts * cap + 1), dtype=torch.bool, device=x.device)
        ours[torch.arange(t, device=x.device)[:, None], routes.slot] = True
        same_routes = bool(torch.equal(ours[:, :-1].view(dispatch.shape), dispatch))
        want = want.float()
        err = (got - want).abs().max().item()
        tol = 2 * 2.0 ** -7 * want.abs().max().item()
    out = dict(tokens=t, capacity=cap, same_routes=same_routes, max_abs_err=err, tol=tol,
               aux=layer.aux_loss.item(), aux_plain=aux.item(),
               dropped=layer.dropped_frac.item(), dropped_plain=dropped.item())
    del model, layer, x, seen, got, want, dispatch, ours, routes
    return out


def branches_runs(torch, card, serve, per_tick, mha, prompts, serve_kw, tmp, recipe_argv,
                  dev="cuda") -> dict:
    """(c) the LM's model branches on the card. ``mha``: the MHA serve's
    launches (``launches``) and warmed graph serves (``warm_bf16``,
    ``warm_fp8``) and its train step p50 (``step_s``), for comparison.

    - The serve: ``Scheduler`` on the full-width GQA + RoPE LM (``serve``
      with ``model=``), warmed CUDA graphs, bf16 and fp8 pools of the MHA
      serve's block count (a third of its bytes, checked); kernels 7 and 8
      launched as often as in the MHA serve, every launch on the tensor
      cores, the fp8 serve's new rows all on the append route (kernel 9);
      12 split launches a decode tick; the final prefill logits against a
      ``gather_impl="dense"`` engine (within 0.25, as the MHA serve's), the
      greedy match with a dense-gather serve and the fp8 serve's with the
      bf16 one; tick p50, tok/s and TTFT p50 beside the MHA serve's. The
      warmed bf16 serve drains the prompts again (``serve_record``): every
      decode logits row a token was drawn from within ``DECODE_TOL["bf16"]``
      of the plain model's full causal forward, as the batchers' rows are.
    - The dense path: ``generate_ragged`` in fp32 (``ragged_fp32``): its
      tokens the argmax of its steps' logits, those within
      ``DECODE_TOL["fp32"]`` of the full causal forward, equal to
      per-request ``generate``'s; bf16 ``generate`` inside the vocabulary.
    - Training: ``LMTrainer`` on flash, ``TRAIN`` steps, 12 forward and 12
      fused backward launches a step; the first step against dense
      attention (B 2, ``TRAIN_LOSS_TOL`` / ``TRAIN_GRAD_NORM_RTOL``);
      dropout 0.1: two runs from one seed bit-equal (losses and state), and
      a suspend at step 4 then a resume bit-equal to them
      (``check_resumed``); the step p50 beside the MHA step's.
    - MoE: 8 experts top-1 and top-2, ``moe_steps`` steps on flash, finite
      losses and ``moe_dropped_frac``; the first MoE layer on B 8 x 2048
      tokens against a plain one-hot spelling (``moe_against_one_hot``:
      routes, output, aux loss, drop share); each first step against dense.
    - Blockwise: the first step against dense at B 2, each step's peak
      memory.
    - The recipe: ``lm_pretrain`` with ``recipe_argv`` (on the card
      ``--synthetic --kv-heads 4 --pos-embedding rope --dropout 0.1``) to
      its end in a process of its own.

    Returns the kernels' launches in the phase (``launches``: the paged
    kernels' from both serves, ``flash``: kernels 4 and 5 from the GQA
    trainer) and the figures. Fails the run on any problem."""
    import gc
    import shutil

    from pytorch_distributed_tpu_torch.data import SyntheticTokens
    from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
    from pytorch_distributed_tpu_torch.models.generate import generate
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_tpu_torch.ops import paged_flash as pf
    from pytorch_distributed_tpu_torch.recipes.serve_lm import full_config
    from pytorch_distributed_tpu_torch.resilience import faults
    from pytorch_distributed_tpu_torch.resilience.faults import FaultPlan, FaultSpec
    from pytorch_distributed_tpu_torch.serving import Scheduler, pool_block_bytes
    from pytorch_distributed_tpu_torch.train import (
        LMTrainer,
        LMTrainerConfig,
        create_lm_state,
        lm_collate,
        make_lm_train_step,
    )
    from pytorch_distributed_tpu_torch.utils.suspend import SuspendWatcher

    t_phase = time.perf_counter()
    problems: list = []
    out: dict = {"launches": {}}
    max_new = 32
    gcfg = full_config(**BRANCH_MODEL)
    mha_cfg = full_config()
    gstate = params_from_jax(init_params(gcfg, seed=0))
    model = (gcfg, gstate)

    # ---- the serve, bf16 and fp8 pools, warmed CUDA graphs ----
    serves = {}
    for kind, kw in (("bf16", {}), ("fp8", {"kv_dtype": "fp8"})):
        sched, streams, m, wall, launches = serve(
            f"GQA + RoPE (H 12 over H_kv 4), {kind} pools, warmed up", prompts, warm=True,
            model=model, **kw)
        n = sched.engine.allocator.n_blocks
        dt = sched.engine.cache[0].key.dtype
        gqa_bytes = n * pool_block_bytes(gcfg, 16, kw.get("kv_dtype"))
        mha_bytes = n * pool_block_bytes(mha_cfg, 16, kw.get("kv_dtype"))
        tick = per_tick(sched.engine)
        sweep, split = ((pf.variant(k, dt) if kw else k) for k in (pf.SWEEP, pf.SPLIT))
        want = [mha["launches"].get(pf.SWEEP, 0), mha["launches"].get(pf.SPLIT, 0)]
        got = [launches.get(sweep, 0), launches.get(split, 0)]
        tc = [launches.get(pf.route_key(k, pf.TENSOR_CORES), 0) for k in (pf.SWEEP, pf.SPLIT)]
        appended = sum(launches.get(pf.append_key(k, dt), 0) for k in (pf.SWEEP, pf.SPLIT)
                       ) if kw else 0
        w = mha[f"warm_{kind}"]
        serves[kind] = dict(streams=streams, tick_p50_s=m["tick_p50_s"],
                            tok_per_s=m["tokens_out"] / wall, ttft_p50_s=m["ttft_p50_s"],
                            pool_bytes=gqa_bytes, mha_pool_bytes=mha_bytes, n_blocks=n,
                            launches=got, append_launches=appended, tick_launches=tick)
        print(f"(c) branches: GQA + RoPE serve, {kind} pools, warmed graphs, on {card}: tick "
              f"p50 {m['tick_p50_s'] * 1e3:.3f} ms (MHA {w['graphs_tick_p50_s'] * 1e3:.3f}), "
              f"{m['tokens_out'] / wall:.1f} tok/s (MHA {w['graphs_tok_per_s']:.1f}), TTFT p50 "
              f"{m['ttft_p50_s'] * 1e3:.1f} ms (MHA {w['graphs_ttft_p50_s'] * 1e3:.1f}); pool "
              f"{n} blocks {gqa_bytes} bytes against the MHA pool's {mha_bytes} "
              f"({gqa_bytes / mha_bytes:.4f}x); kernel 7 / 8 launches {got} (the MHA serve "
              f"{want}), on the tensor cores {tc}, append route {appended}; a decode tick "
              f"{tick}")
        if got != want or tc != got or gqa_bytes * 3 != mha_bytes:
            problems.append(f"GQA {kind} serve: launches {got} (tensor cores {tc}) against the "
                            f"MHA serve's {want}; pool bytes {gqa_bytes} vs {mha_bytes}")
        if tick.get(split, 0) != gcfg.num_layers:
            problems.append(f"GQA {kind} decode tick launches {tick}")
        if kind == "fp8" and appended != sum(got):
            problems.append(f"GQA fp8 serve: {appended} append launches, {got} attention")
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        if kind == "fp8":  # kernel 9's launches are the append route's
            q9 = pf.variant(pf.QUANTIZE, dt)
            out["launches"][q9] = out["launches"].get(q9, 0) + appended
        else:  # the warmed serve again: its decode rows against the full forward
            rec = serve_record(sched)
            rids = [sched.submit(p, max_new) for p in prompts]
            again = sched.drain()
            plain = plain_model(torch, gcfg, gstate, dev)
            row_err, n_rows = 0.0, 0
            for p, rid in zip(prompts, rids):
                want = full_forward_rows(torch, plain, p, again[rid], dev)[1:]
                got = torch.as_tensor(np.stack([np.frombuffer(r, np.float32) for r in
                                                rec["rows"][rid][:len(want)]]), device=dev)
                row_err = max(row_err, (got - want).abs().max().item()
                              if got.shape == want.shape else float("inf"))
                n_rows += len(got)
            print(f"(c) branches: GQA + RoPE bf16 serve, warmed graphs, again: every decode "
                  f"logits row a token was drawn from ({n_rows} rows) against the plain "
                  f"model's full causal forward, max_abs_err {row_err:.4f} (limit "
                  f"{DECODE_TOL['bf16']})")
            if not row_err <= DECODE_TOL["bf16"]:
                problems.append(f"GQA bf16 serve: decode rows {row_err} from the full forward")
            serves[kind].update(drawn_rows_max_abs_err=row_err, drawn_rows=n_rows)
            del plain, rec
        del sched
        empty_cache(torch, dev)

    pair = [prompts[1], prompts[2]]
    rows = {impl: final_prefill_logits(torch, gcfg, gstate, pair, max_new, impl, dev)
            for impl in ("kernel", "dense")}
    logit_err = (rows["kernel"] - rows["dense"]).abs().max().item()
    s = Scheduler(gcfg, gstate, gather_impl="dense", **serve_kw)
    rids = [s.submit(p, max_new) for p in prompts]
    done = s.drain()
    dense_streams = [done[r] for r in rids]
    del s
    empty_cache(torch, dev)
    match = match_rate(serves["bf16"]["streams"], dense_streams)
    fp8_match = match_rate(serves["fp8"]["streams"], serves["bf16"]["streams"])
    print(f"(c) branches: GQA + RoPE final-prefill logits, kernel vs plain gather, prompts "
          f"{[len(p) for p in pair]}: max_abs_err {logit_err:.4f} (limit 0.25); greedy match "
          f"with the dense-gather serve over {len(prompts)} x {max_new} tokens {match:.3f}; fp8 "
          f"pools against bf16 pools {fp8_match:.3f}")
    if not logit_err <= 0.25:
        problems.append(f"GQA final-prefill logits {logit_err} from the plain gather's")
    out["serve"] = {k: {n: v for n, v in r.items() if n != "streams"} for k, r in serves.items()}
    out["serve"].update(prefill_max_abs_err=logit_err, dense_match=match, fp8_match=fp8_match)

    # ---- the dense path ----
    four = prompts[:4]
    drawn, err32, same32 = ragged_fp32(torch, gcfg, gstate, four, 16, dev)
    gen = generate(gcfg, gstate, four[0][None], 16, device=dev).cpu().numpy()
    print(f"(c) branches: GQA + RoPE generate_ragged in fp32, prompts {[len(q) for q in four]} "
          f"x 16: tokens the argmax of its steps' logits {drawn}, those against the full "
          f"causal forward max_abs_err {err32:.2e} (limit {DECODE_TOL['fp32']}), equal to "
          f"per-request generate's {same32}; bf16 generate {gen.shape}")
    if not (drawn and err32 <= DECODE_TOL["fp32"] and same32 and gen.shape == (1, len(four[0]) + 16)
            and ((gen >= 0) & (gen < gcfg.vocab_size)).all()):
        problems.append(f"GQA dense decode: drawn {drawn}, err {err32}, same {same32}")
    out["dense_decode"] = {"max_abs_err": err32, "drawn": drawn, "equal_to_generate": same32}
    empty_cache(torch, dev)

    # ---- training: LMTrainer on flash ----
    bsz, seq, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    tcfg = full_config(attention="flash", **BRANCH_MODEL)

    def trainer(cfg, n_steps, save="t", watcher=None, **kw):
        return LMTrainer(cfg, SyntheticTokens(n_steps * bsz, seq, cfg.vocab_size),
                         SyntheticTokens(bsz, seq, cfg.vocab_size, seed=1),
                         LMTrainerConfig(batch_size=bsz, lr=3e-4, warmup_steps=0, log_every=1,
                                         grad_clip_norm=1.0, save_dir=os.path.join(tmp, save),
                                         **kw),
                         device=dev, suspend_watcher=watcher)

    def release(*dirs):
        for d in dirs:
            shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)
        gc.collect()
        empty_cache(torch, dev)

    t = trainer(tcfg, steps)
    sync(torch, dev)
    fa.reset_launch_counts()
    t.train_epoch(0)
    sync(torch, dev)
    train_launches = dict(fa.launch_counts)
    losses = [r["loss"] for r in t.history]
    step_s = float(np.median([r["step_s"] for r in t.history[1:]]))
    n = tcfg.num_layers * (1 if dev == "cuda" else 0)  # the plain versions count nothing
    print(f"(c) branches: GQA + RoPE LMTrainer, {steps} steps of B={bsz} x L={seq}, flash, on "
          f"{card}: losses {[round(x, 4) for x in losses]}; step p50 {step_s * 1e3:.1f} ms "
          f"(the MHA step {mha['step_s'] * 1e3:.1f} ms), {bsz * seq / step_s:.0f} tokens/s; "
          f"launches {train_launches} ({n} + {n} a step wanted)")
    if (train_launches.get(fa.FWD) != n * steps or train_launches.get(fa.BWD) != n * steps
            or not all(np.isfinite(losses)) or len(losses) != steps):
        problems.append(f"GQA trainer: launches {train_launches}, losses {losses}")
    out["flash"] = {fa.FWD: train_launches.get(fa.FWD, 0), fa.BWD: train_launches.get(fa.BWD, 0)}
    out["train"] = {"step_p50_s": step_s, "losses": losses, "mha_step_p50_s": mha["step_s"]}
    del t
    release("t")

    pair_batch = {k: torch.from_numpy(v).to(dev) for k, v in lm_collate(
        [SyntheticTokens(2, seq, gcfg.vocab_size, seed=2)[i] for i in range(2)]).items()}

    def first_step(cfg, params, label):
        """Loss, grad norm and peak memory of one step from ``params`` on
        ``pair_batch``."""
        st = create_lm_state(cfg, lr_schedule=lambda step: 0.0, params=params, device=dev)
        sync(torch, dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _, m = make_lm_train_step(grad_clip_norm=1.0, config=cfg)(st, pair_batch)
        got = {k: float(v) for k, v in m.items()}
        got["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda" else 0.0
        del st, m
        empty_cache(torch, dev)
        return got

    def against_dense(label, cfg_of, params, attns=("flash",)):
        res = {a: first_step(cfg_of(a), params, label) for a in (*attns, "dense")}
        for a in attns:
            d_loss = abs(res[a]["loss"] - res["dense"]["loss"])
            d_norm = abs(res[a]["grad_norm"] / res["dense"]["grad_norm"] - 1)
            print(f"(c) branches: {label} first step B=2 x L={seq}, {a} vs dense: loss "
                  f"{res[a]['loss']:.5f} vs {res['dense']['loss']:.5f} (|diff| {d_loss:.2e}, "
                  f"tol {TRAIN_LOSS_TOL:g}); grad norm {res[a]['grad_norm']:.5f} vs "
                  f"{res['dense']['grad_norm']:.5f} (rel diff {d_norm:.2e}, tol "
                  f"{TRAIN_GRAD_NORM_RTOL:g}); peak memory {res[a]['peak_gib']:.2f} vs "
                  f"{res['dense']['peak_gib']:.2f} GiB")
            if not (d_loss <= TRAIN_LOSS_TOL and d_norm <= TRAIN_GRAD_NORM_RTOL):
                problems.append(f"{label}: {a} first step against dense: loss {d_loss}, "
                                f"grad norm {d_norm}")
        return res

    out["first_step"] = against_dense(
        "GQA + RoPE", lambda a: full_config(attention=a, **BRANCH_MODEL), gstate,
        ("flash", "blockwise"))

    # ---- dropout: two runs from one seed, a suspend and a resume ----
    dcfg = dataclasses.replace(tcfg, dropout=BRANCH["dropout"])
    dsteps, k = BRANCH["dropout_steps"], BRANCH["suspend_at"]
    runs, hist = {}, {}
    for name in ("d1", "d2"):
        t = trainer(dcfg, dsteps, name)
        t.fit()
        runs[name], hist[name] = state_copy(torch, t), [r["loss"] for r in t.history]
        del t
        release(name)
    repeat = state_diff(torch, runs["d1"], runs["d2"])
    print(f"(c) branches: dropout {BRANCH['dropout']}, {dsteps} steps twice from one seed: "
          f"losses {[round(x, 4) for x in hist['d1']]}, bit-equal "
          f"{hist['d1'] == hist['d2']}; states {repeat}")
    if hist["d1"] != hist["d2"] or any(repeat.values()):
        problems.append(f"dropout runs from one seed differ: {hist}, {repeat}")
    faults.install_plan(FaultPlan([FaultSpec("train.step", "suspend", at=k)]))
    t = trainer(dcfg, dsteps, "ds", SuspendWatcher(install_handlers=False))
    try:
        t.fit()
        problems.append("the dropout run did not suspend")
    except SystemExit:
        pass
    finally:
        faults.clear_plan()
    del t
    t = trainer(dcfg, dsteps, "ds")
    t.fit()
    check_resumed(problems, f"branches: dropout suspend at step {k} / resume", repeat,
                  state_diff(torch, state_copy(torch, t), runs["d1"]))
    out["dropout"] = {"losses": hist["d1"], "repeat": repeat}
    del t, runs
    release("ds")

    # ---- MoE: 8 experts, top-1 and top-2 ----
    out["moe"] = {}
    moe_tokens = torch.from_numpy(np.stack(
        [SyntheticTokens(bsz, seq, gcfg.vocab_size)[i] for i in range(bsz)])).to(dev).long()
    for top_k in (1, 2):
        mcfg = full_config(attention="flash", n_experts=BRANCH["moe_experts"], moe_top_k=top_k)
        t = trainer(mcfg, BRANCH["moe_steps"], "m")
        t.train_epoch(0)
        sync(torch, dev)
        mlosses = [r["loss"] for r in t.history]
        dropped = [r["moe_dropped_frac"] for r in t.history]
        m_step = float(np.median([r["step_s"] for r in t.history[1:]]))
        print(f"(c) branches: MoE {mcfg.n_experts} experts top-{top_k} (every "
              f"{mcfg.moe_every}nd block, capacity {mcfg.capacity_factor}), "
              f"{BRANCH['moe_steps']} steps of B={bsz} x L={seq}, flash, on {card}: losses "
              f"{[round(x, 4) for x in mlosses]}, moe_dropped_frac "
              f"{[round(x, 4) for x in dropped]}, step p50 {m_step * 1e3:.1f} ms")
        if not all(np.isfinite(mlosses)) or not all(0.0 <= x < 1.0 for x in dropped):
            problems.append(f"MoE top-{top_k}: losses {mlosses}, dropped {dropped}")
        del t
        release("m")
        mparams = params_from_jax(init_params(mcfg, seed=0))
        one_hot = moe_against_one_hot(torch, mcfg, mparams, moe_tokens, dev)
        empty_cache(torch, dev)
        print(f"(c) branches: MoE top-{top_k}, the first MoE layer on its input from B={bsz} x "
              f"L={seq} synthetic tokens (T {one_hot['tokens']}, capacity "
              f"{one_hot['capacity']}) against a plain one-hot [T, E, C] dispatch and "
              f"combine: routes equal {one_hot['same_routes']}; "
              f"output max_abs_err {one_hot['max_abs_err']:.3e} (limit {one_hot['tol']:.3e}, "
              f"two bf16 ulps of its largest); aux loss {one_hot['aux']:.6f} vs "
              f"{one_hot['aux_plain']:.6f}; dropped_frac {one_hot['dropped']:.4f} vs "
              f"{one_hot['dropped_plain']:.4f}")
        if not (one_hot["same_routes"] and one_hot["max_abs_err"] <= one_hot["tol"]
                and rel_err(one_hot["aux"], one_hot["aux_plain"]) <= 1e-5
                and one_hot["dropped"] == one_hot["dropped_plain"]):
            problems.append(f"MoE top-{top_k} against the one-hot spelling: {one_hot}")
        first = against_dense(f"MoE top-{top_k}",
                              lambda a, c=mcfg: dataclasses.replace(c, attention=a), mparams)
        out["moe"][f"top{top_k}"] = {"losses": mlosses, "dropped": dropped,
                                     "step_p50_s": m_step, "first_step": first,
                                     "one_hot": one_hot}
        del mparams

    # ---- the recipe in a process of its own ----
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytorch_distributed_tpu_torch.recipes.lm_pretrain",
                        *recipe_argv, "--save-dir", os.path.join(tmp, "recipe")],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    recipe_s = time.perf_counter() - t0
    try:
        summary = json.loads(r.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        summary = {}
    print(f"(c) branches: lm_pretrain {' '.join(recipe_argv)}: exit {r.returncode} in "
          f"{recipe_s:.1f}s, validation loss {summary.get('loss')}")
    if r.returncode != 0 or not np.isfinite(summary.get("loss", float("nan"))):
        problems.append(f"lm_pretrain: exit {r.returncode}: {r.stderr[-2000:]}")
    out["recipe"] = {"exit": r.returncode, "seconds": recipe_s, "loss": summary.get("loss")}
    release("recipe")

    out["wall_s"] = time.perf_counter() - t_phase
    print(f"(c) branches phase: {out['wall_s']:.1f} s")
    if problems:
        raise SystemExit(f"chip_smoke: the model-branches phase failed: {problems}")
    return out


def lagged_drain(sched, max_ticks=100_000) -> dict:
    """Drive ``sched`` by its lagged loop, ``collect_tick();
    dispatch_tick()`` each iteration (one tick in flight between them),
    until it is idle after a collect; returns ``{rid: [tokens]}``."""
    streams = {}
    for _ in range(max_ticks):
        for rid, tok in sched.collect_tick():
            streams.setdefault(rid, []).append(tok)
        if sched.idle:
            return streams
        sched.dispatch_tick()
    raise SystemExit(f"chip_smoke: the lagged loop did not converge: {sched.stuck_rids()}")


def scripted_serve(sched, reqs, max_new, script, picks, lagged):
    """Serve ``reqs`` by ``step()`` or by the lagged loop and act on them
    along ``script``, a list of ``(choose, act)``: after each tick
    (lagged: with it in flight) the next entry's ``choose(stuck_rids())``
    names the rids to act on, or None to wait, and ``act(sched, rids)``
    acts. Where ``picks`` is empty (the ``step()`` run) the ticks and rids
    are recorded there; otherwise they are replayed from it, so both loops
    act on the same requests at the same ticks. Returns the rids, the
    streams and each action's results."""
    record = not picks
    rids = [sched.submit(p, max_new) for p in reqs]
    streams, results = {}, []
    for tick in range(1, 100_000):
        if lagged:
            got = sched.collect_tick()
        elif sched.idle:
            break
        else:
            got = sched.step()
        for rid, tok in got:
            streams.setdefault(rid, []).append(tok)
        if lagged:
            if sched.idle:
                break
            sched.dispatch_tick()
        i = len(results)
        if i == len(script):
            continue
        if record:
            chosen = script[i][0](sched.stuck_rids())
            if chosen is None:
                continue
            picks[i] = (tick, chosen)
        elif picks[i][0] != tick:
            continue
        results.append(script[i][1](sched, picks[i][1]))
    if len(results) != len(script):
        raise SystemExit(f"chip_smoke: a scripted serve took {len(results)} of its "
                         f"{len(script)} actions")
    return rids, streams, results


def serve_record(sched, plant=None) -> dict:
    """Instrument ``sched`` so that two serves whose schedules differ can be
    held bit for bit. A request's numbers depend on its schedule only
    through its prefill: a chunk program's shape (its bucket) sets the
    rounding, while a decode lane at a fixed ``n_slots`` reads only its own
    chain, position and token. Records per rid ``prefill``, the ``(bucket,
    start)`` of every chunk it rode, and ``rows``, the bytes of every
    logits row its decode ticks wrote (fp32, on the host); and ``raised``,
    the rids whose swap-out (``"swap_out"``) or swap-in (``"swap_in"``)
    raised. ``plant(sched, slot)``, when given, runs after every swap-in
    that retries a failed one: a planted fault the comparison must see.

    The wrappers sit on the engine and hold the scheduler weakly: a strong
    reference would make a cycle, and a cycle collection that frees an
    engine's CUDA graphs in the middle of a later serve's capture breaks
    that capture."""
    rec = {"prefill": {}, "rows": {}, "raised": {"swap_out": [], "swap_in": []}}
    cls, ref = type(sched.engine), weakref.ref(sched)
    in_flight = []  # one tick at a time: the lanes of the launched decode

    def chunks(jobs):
        s = ref()
        bucket = s.engine.bucket_for(jobs)
        for j in jobs:
            rec["prefill"].setdefault(s.resident[j.slot].rid, []).append((bucket, j.start))
        return cls.run_chunks(s.engine, jobs)

    def decode_launch(positions, active):
        s = ref()
        in_flight.append([(int(i), s.resident[int(i)].rid) for i in np.nonzero(active)[0]])
        return cls.decode_launch(s.engine, positions, active)

    def decode_collect(tokens, positions):
        eng = ref().engine
        out = cls.decode_collect(eng, tokens, positions)
        lanes = in_flight.pop()
        rows = eng.logits[[slot for slot, _ in lanes]].float().cpu().numpy()
        for (_, rid), row in zip(lanes, rows):
            rec["rows"].setdefault(rid, []).append(row.tobytes())
        return out

    def swap_out(pending, store, rid):
        try:
            return cls.swap_out_finish(ref().engine, pending, store, rid)
        except OSError:
            rec["raised"]["swap_out"].append(rid)
            raise

    def swap_in(slot, chain):
        s = ref()
        rid = next(r for r, (_, path) in s.parked.items()
                   if path == "swap" and s.host_store.get(r) is chain)
        try:
            restored = cls.swap_in_chain(s.engine, slot, chain)
        except OSError:
            rec["raised"]["swap_in"].append(rid)
            raise
        if restored and plant is not None and rid in rec["raised"]["swap_in"]:
            plant(s, slot)
        return restored

    eng = sched.engine
    eng.run_chunks, eng.decode_launch, eng.decode_collect = chunks, decode_launch, decode_collect
    eng.swap_out_finish, eng.swap_in_chain = swap_out, swap_in
    return rec


def exact_rids(rec, ref, streams, ref_streams):
    """Two ``serve_record`` records of serves of the same requests: the
    rids whose chunks rode the same buckets in both (their numbers must
    then agree bit for bit), and of those the ones whose stream or logits
    rows differ."""
    same = sorted(rid for rid, shapes in rec["prefill"].items()
                  if shapes == ref["prefill"].get(rid))
    return same, [rid for rid in same if streams[rid] != ref_streams[rid]
                  or rec["rows"].get(rid) != ref["rows"].get(rid)]


def zero_first_block(sched, slot):
    """A planted fault: the first block of ``slot``'s chain zeroed in
    every pool tensor of every layer."""
    block = sched.engine.allocator.chain(slot)[0]
    for layer in sched.engine.cache:
        for t in layer:
            if t is not None:
                t[block] = 0


def swap_faults_exact(torch, cfg, state, serve_kw, prompt, kv_dtype, dev="cuda") -> dict:
    """Each ``kv.*`` site raised once on one prefilled chain, compared bit
    for bit: a swap-out failing at ``kv.swap_out_d2h`` or ``kv.host_write``
    leaves the chain resident with every pool tensor (scales included) and
    the logits row unchanged and the host store empty; a swap-in failing
    at ``kv.swap_in_h2d`` frees the fresh chain and keeps the host copy,
    and the retry restores every block and the logits row exactly.
    Returns ``{check: passed}``."""
    from pytorch_distributed_tpu_torch.resilience import faults
    from pytorch_distributed_tpu_torch.serving import ChunkJob, HostBlockStore, PagedEngine

    c = serve_kw["prefill_chunk"]
    eng = PagedEngine(cfg, state, n_slots=2, block_len=serve_kw["block_len"],
                      prefill_chunk=c, kv_dtype=kv_dtype, swap=True, device=dev)
    eng.admit(0, len(prompt), 32)
    for start in range(0, len(prompt), c):
        seg = np.zeros(c, np.int32)
        seg[:len(prompt[start:start + c])] = prompt[start:start + c]
        last = start + c >= len(prompt)
        eng.run_chunks([ChunkJob(0, seg, start, last, len(prompt) - 1 - start if last else 0)])

    def contents(slot):
        idx = torch.tensor(eng.allocator.chain(slot), dtype=torch.long, device=eng.device)
        return [t[idx].clone() for layer in eng.cache for t in layer if t is not None] + [
            eng.logits[slot].clone()]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def raising(site, fn):
        faults.install_plan(faults.FaultPlan([faults.FaultSpec(site=site, kind="raise")]))
        try:
            fn()
        except OSError:
            return True
        finally:
            faults.clear_plan()
        return False

    store, chain, before = HostBlockStore(), eng.allocator.chain(0), contents(0)
    out = {}
    for site in ("kv.swap_out_d2h", "kv.host_write"):
        pending = eng.swap_out_begin(0)
        raised = raising(site, lambda: eng.swap_out_finish(pending, store, 0))
        out[site] = (raised and eng.allocator.chain(0) == chain and not eng.allocator.swapping()
                     and len(store) == 0 and same(contents(0), before))
    host = eng.swap_out_finish(eng.swap_out_begin(0), store, 0)
    in_use = eng.allocator.in_use
    raised = raising("kv.swap_in_h2d", lambda: eng.swap_in_chain(1, store.get(0)))
    freed = eng.allocator.in_use == in_use == 0 and 0 in store
    restored = eng.swap_in_chain(1, store.pop(0))
    out["kv.swap_in_h2d"] = (raised and freed and restored
                             and same(contents(1), before) and host.n_blocks == len(chain))
    eng.release_all()
    return out


def final_prefill_logits(torch, cfg, state, pair, max_new, impl, dev="cuda"):
    """The logits rows ``PagedEngine`` leaves after prefilling the prompts
    of ``pair`` chunk by chunk (2 slots, blocks of 16, chunks of 32) with
    ``gather_impl=impl``."""
    from pytorch_distributed_tpu_torch.serving import PagedEngine
    from pytorch_distributed_tpu_torch.serving.engine import ChunkJob

    e = PagedEngine(cfg, state, n_slots=2, block_len=16, prefill_chunk=32,
                    gather_impl=impl, device=dev)
    for slot, p in enumerate(pair):
        e.admit(slot, len(p), max_new)
    done = [0, 0]
    while any(done[s] < len(pair[s]) for s in range(2)):
        jobs = []
        for s, p in enumerate(pair):
            if done[s] >= len(p):
                continue
            toks = np.zeros(32, np.int32)
            seg = p[done[s]:done[s] + 32]
            toks[:len(seg)] = seg
            last = done[s] + 32 >= len(p)
            jobs.append(ChunkJob(s, toks, done[s], last, len(p) - 1 - done[s] if last else 0))
            done[s] += 32
        e.run_chunks(jobs)
    return e.logits.clone()


def plain_model(torch, config, state, dev="cuda"):
    """A ``TransformerLM`` of ``config`` with the weights ``state``, for
    inference."""
    from pytorch_distributed_tpu_torch.models.transformer import TransformerLM

    with torch.device(dev):
        model = TransformerLM(config)
    model.load_state_dict(state)
    return model.eval().requires_grad_(False)


def full_forward_rows(torch, model, prompt, stream, dev="cuda"):
    """The full causal forward's logits at the positions that drew
    ``stream`` after ``prompt``."""
    seq = np.concatenate([prompt, np.asarray(stream[:-1], np.int32)])
    with torch.no_grad():
        full = model(torch.as_tensor(seq[None], device=dev).long())[0].float()
    return full[len(prompt) - 1:]


def ragged_fp32(torch, cfg, state, prompts, n_new, dev="cuda"):
    """``generate_ragged`` in fp32 (``cfg`` at fp32, weights ``state``) on
    ``prompts``: whether its tokens are the argmax of the logits its
    prefill and per-request decode steps give, those logits' largest
    distance from the full causal forward, and whether per-request
    ``generate`` gives the same tokens."""
    from pytorch_distributed_tpu_torch.models.generate import (
        generate,
        generate_ragged,
        ragged_decode_step,
        ragged_prefill,
    )

    lengths = [len(q) for q in prompts]
    padded = np.zeros((len(prompts), max(lengths)), np.int32)
    for i, q in enumerate(prompts):
        padded[i, :len(q)] = q
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    m32 = plain_model(torch, cfg32, state, dev)
    tokens32 = generate_ragged(cfg32, m32, padded, lengths, n_new)
    alone32 = [generate(cfg32, m32, q[None], n_new)[0, len(q):] for q in prompts]
    cache, logits = ragged_prefill(cfg32, m32, padded, lengths)
    stepped, pos = [logits], torch.as_tensor(lengths, device=dev)
    for i in range(n_new - 1):
        cache, logits = ragged_decode_step(cfg32, m32, cache, tokens32[:, i], pos + i)
        stepped.append(logits)
    stepped = torch.stack(stepped, dim=1)
    del cache
    drawn = bool(torch.equal(stepped.argmax(-1).to(torch.int32), tokens32))
    err32 = max((stepped[i] - full_forward_rows(torch, m32, q, tokens32[i].tolist(), dev))
                .abs().max().item() for i, q in enumerate(prompts))
    same32 = all(torch.equal(a, r) for a, r in zip(alone32, tokens32))
    return drawn, err32, same32


def lifecycle_runs(torch, card, serve, cfg, state, prompts, serve_kw, *, pressure_kw,
                   pressure_streams, busy, recipe_argv, dev="cuda") -> dict:
    """(c) the request lifecycle and the dense decode path. The warmed-up
    bf16 graph serve by ``step()`` and by the lagged loop (``lagged_drain``):
    streams and every launch counter bit-equal, tick p50, tok/s, TTFT and
    the busy share (``busy``: ``graph_runs``'s, the lagged loop a path of
    its own) side by side. The over-committed fp8 serve (``pressure_kw``,
    preempting on OOM by swap) by the lagged loop against its ``step()``
    streams (``pressure_streams``), and under a plan raising once at each
    ``kv.*`` site: every site fires, at least 3 swap aborts, nothing left
    behind, and every request whose chunks rode the same prefill buckets
    as in the fault-free serve (the faulted ones among them) bit-equal to
    it in stream and logits rows (``serve_record``); the same plan with the
    retried chain's first block zeroed must differ in that request alone.
    Cancels in every state and deadlines at fixed ticks
    (``scripted_serve``), by ``step()`` and by the lagged loop: queued,
    mid-prefill and decoding cancels and a queued and a decoding deadline
    on the bf16 graph serve, mid swap-out and parked cancels on the fp8
    one; survivors' streams and launches bit-equal between the loops, the
    counters as scripted, every block free and every table row trash
    after. ``drain_graceful`` with requests queued returns exactly them;
    ``abandon`` with a tick in flight frees every block and refuses the
    next ``submit``. The dense path: ``ContinuousBatcher`` dense against
    paged at 8 slots (the paged one's sweep and split launches counted,
    every logits row a token was drawn from within ``DECODE_TOL["bf16"]``
    of the full causal forward, greedy match, each tick's p50);
    ``generate_ragged`` on 4 prompts against per-request ``generate``, and
    in fp32 its tokens the argmax of its prefill and decode steps' logits,
    those within ``DECODE_TOL["fp32"]`` of the full forward; and
    ``recipe_argv`` (``serve_lm --dense``) run to its end in a process of
    its own. Fails the run on any difference."""
    from pytorch_distributed_tpu_torch.models.generate import (
        ContinuousBatcher,
        generate,
        generate_ragged,
    )
    from pytorch_distributed_tpu_torch.ops import paged_flash
    from pytorch_distributed_tpu_torch.resilience import faults
    from pytorch_distributed_tpu_torch.serving import TRASH_BLOCK, Scheduler

    t_phase = time.perf_counter()
    max_new = 32
    out = {}
    problems = []

    # the lagged loop against step(), the bf16 graph serve warmed up
    runs = {}
    for loop in ("step", "lagged"):
        _, streams, m, wall, launches = serve(f"bf16 pools, graphs, {loop} loop, warmed up",
                                              prompts, warm=True, lagged=loop == "lagged")
        runs[loop] = {"streams": streams, "launches": launches, "tok_per_s":
                      m["tokens_out"] / wall, "tick_p50_s": m["tick_p50_s"],
                      "ttft_p50_s": m["ttft_p50_s"], "ttft_p95_s": m["ttft_p95_s"]}
        empty_cache(torch, dev)
    s, g = runs["step"], runs["lagged"]
    print(f"(c) lifecycle: step() vs the lagged loop, bf16 graphs, warmed up, on {card}: tick "
          f"p50 {s['tick_p50_s'] * 1e3:.3f} vs {g['tick_p50_s'] * 1e3:.3f} ms, "
          f"{s['tok_per_s']:.1f} vs {g['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{s['ttft_p50_s'] * 1e3:.1f} vs {g['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{s['ttft_p95_s'] * 1e3:.1f} vs {g['ttft_p95_s'] * 1e3:.1f} ms, busy share "
          f"{busy['graphs_busy']:.3f} vs {busy['lagged_busy']:.3f}")
    if s["streams"] != g["streams"] or s["launches"] != g["launches"]:
        problems.append(f"the lagged loop's serve differs from step()'s (streams equal: "
                        f"{s['streams'] == g['streams']}; launches {s['launches']} vs "
                        f"{g['launches']})")
    out["loops"] = {f"{loop}_{k}": v for loop, r in runs.items() for k, v in r.items()
                    if k not in ("streams", "launches")}
    out["loops"].update(step_busy=busy["graphs_busy"], lagged_busy=busy["lagged_busy"])

    # the pressure tier by the lagged loop, then under a fault at every kv.* site
    recs = {}

    def recorded(name, plant=None):
        return lambda sched: recs.__setitem__(name, serve_record(sched, plant))

    _, lag_pressure, mp, _, _ = serve("pressure, fp8 pools, swap, lagged loop", prompts,
                                      lagged=True, hook=recorded("free"), **pressure_kw)
    if lag_pressure != pressure_streams:
        problems.append("the lagged pressure serve's streams differ from step()'s")
    sites = ("kv.swap_out_d2h", "kv.host_write", "kv.swap_in_h2d")
    faulted = {}
    # "planted": the step loop again, the retried chain's first block zeroed
    for loop in ("step", "lagged", "planted"):
        plan = faults.install_plan(faults.FaultPlan(
            [faults.FaultSpec(site=site, kind="raise", at=0) for site in sites]))
        try:
            _, faulted[loop], m, _, _ = serve(
                f"pressure, fp8 pools, swap, a fault at each kv.* site, {loop} loop", prompts,
                lagged=loop == "lagged", hook=recorded(
                    loop, zero_first_block if loop == "planted" else None), **pressure_kw)
        finally:
            faults.clear_plan()
        if loop == "step":
            mf, fired = m, sorted(site for site, _, _ in plan.fired)
    fault_streams, fault_lagged = faulted["step"], faulted["lagged"]
    # a reverted or retried swap changes which prompts share a prefill
    # bucket, whose shapes set the rounding: the requests whose chunks rode
    # the same buckets as in the fault-free serve must match it bit for bit,
    # the faulted ones among them
    raised = recs["step"]["raised"]
    hit = sorted(set(raised["swap_out"] + raised["swap_in"]))
    same, differ = exact_rids(recs["step"], recs["free"], fault_streams, lag_pressure)
    _, planted = exact_rids(recs["planted"], recs["free"], faulted["planted"], lag_pressure)
    match = match_rate(fault_streams, pressure_streams)
    exact = swap_faults_exact(torch, cfg, state, serve_kw, prompts[0], pressure_kw["kv_dtype"],
                              dev)
    print(f"(c) lifecycle: pressure serve lagged: {mp['preempts']} preempts, streams equal "
          f"to step()'s: {lag_pressure == pressure_streams}; under the fault plan: "
          f"{mf['swap_aborts']} swap aborts, {mf['preempts']} preempts, {mf['restores']} "
          f"restores, fired {fired}, streams equal between the loops: "
          f"{fault_lagged == fault_streams}; against the fault-free serve: greedy match "
          f"{match:.3f}, swap-outs raised for rids {raised['swap_out']}, swap-ins for "
          f"{raised['swap_in']}, rids on the same prefill buckets {same}, of which streams or "
          f"logits rows differ {differ}; a planted fault (the retried chain's first block "
          f"zeroed) differs in {planted}; one chain through each site, bit for bit: {exact}")
    if (fired != sorted(sites) or mf["swap_aborts"] < 3 or fault_lagged != fault_streams
            or len(raised["swap_out"]) != 2 or len(raised["swap_in"]) != 1
            or not set(hit) <= set(same) or differ or planted != raised["swap_in"]
            or not all(exact.values())):
        problems.append(f"the kv.* faults: fired {fired}, {mf['swap_aborts']} swap aborts, "
                        f"loops equal {fault_lagged == fault_streams}, raised {raised}, same "
                        f"buckets {same}, differ {differ}, planted {planted}, exact {exact}")
    out["faults"] = {"swap_aborts": mf["swap_aborts"], "preempts": mf["preempts"],
                     "restores": mf["restores"], "streams_equal": fault_streams == pressure_streams,
                     "greedy_match": match, "same_buckets": same, "differ": differ,
                     "faulted": hit, "planted_differ": planted, "exact": exact}

    # cancels and deadlines at fixed ticks, by step() and by the lagged loop
    def lapse(sched, *rids):
        for req in sched.harvest_requests():
            if req.rid in rids:
                req.deadline = 0.0  # long past on the perf_counter clock

    def need(state, n):
        """``choose``: the first and the last rid in ``state`` once it
        holds ``n``."""
        return lambda stuck: ((stuck[state][0], stuck[state][-1])
                              if len(stuck.get(state, ())) >= n else None)

    def bf16_queued(sched, rids):  # a queued cancel and deadline, a mid-prefill cancel
        (q_first, q_last), p_last = rids
        lapse(sched, q_first)
        return sched.cancel(q_last), sched.cancel(p_last)

    def bf16_decoding(sched, rids):  # a decoding cancel and deadline
        first, last = rids
        lapse(sched, last)
        return sched.cancel(first), sched.cancel(10_000)

    def fp8_preempted(policy):
        """Preempt a decoding request by ``policy`` and cancel it: mid
        swap-out (``"swap"``) or parked (``"recompute"``)."""
        def act(sched, rids):
            sched.swap_policy = policy
            choice = sched.preempt(rids[0], reason="chip-smoke").choice
            sched.swap_policy = "swap"
            return choice, sorted(sched.stuck_rids()), sched.cancel(rids[0])
        return act

    def queued_and_prefill(stuck):
        queued, prefill = need("queued", 2)(stuck), need("prefill", 1)(stuck)
        return (queued, prefill[1]) if queued and prefill else None

    scripts = {"bf16": ({}, [(queued_and_prefill, bf16_queued),
                             (need("decoding", 2), bf16_decoding)], (3, 2)),
               "fp8": (pressure_kw, [(need("decoding", 1), fp8_preempted("swap")),
                                     (need("decoding", 1), fp8_preempted("recompute"))],
                       (2, 0))}
    kept = {}
    for kind, (kw, script, (n_cancel, n_deadline)) in scripts.items():
        picks, got = {}, {}
        for loop in ("step", "lagged"):
            sched = Scheduler(cfg, state, gather_impl="kernel", **{**serve_kw, **kw})
            sync(torch, dev)
            paged_flash.reset_launch_counts()
            rids, streams, results = scripted_serve(sched, prompts, max_new, script, picks,
                                                    loop == "lagged")
            sync(torch, dev)
            m = sched.metrics()
            launches = {k: v for counts in (paged_flash.launch_counts,
                                            paged_flash.quant_launch_counts,
                                            paged_flash.route_launch_counts)
                        for k, v in counts.items() if v}
            left = (sched.engine.allocator.in_use, len(sched.host_store),
                    int((np.asarray(sched.engine.tables) != TRASH_BLOCK).sum()))
            got[loop] = (streams, results, launches, m["cancelled"], m["deadline_misses"])
            print(f"(c) lifecycle: {kind} serve, {loop} loop: cancelled {m['cancelled']}, "
                  f"deadline misses {m['deadline_misses']}, completed {m['completed']}, "
                  f"actions {results}; blocks in use, host chains, live table entries "
                  f"after: {left}")
            survivors = [r for r in rids if len(streams.get(r, [])) == max_new]
            if (left != (0, 0, 0) or (m["cancelled"], m["deadline_misses"]) != (
                    n_cancel, n_deadline)
                    or len(survivors) != len(rids) - n_cancel - n_deadline
                    or m["completed"] != len(survivors)):
                problems.append(f"{kind} lifecycle serve, {loop} loop: cancelled "
                                f"{m['cancelled']}, deadline misses {m['deadline_misses']}, "
                                f"{len(survivors)} survivors, left behind {left}")
            if kind == "bf16":
                kept[loop] = sched
        if got["step"] != got["lagged"]:
            problems.append(f"{kind} lifecycle serve: the lagged loop differs from step() "
                            f"(streams equal: {got['step'][0] == got['lagged'][0]})")

    # drain and abandon, on two of the idle schedulers above
    sched = kept["step"]
    for p in prompts:
        sched.submit(p, max_new)
    for _ in range(3):
        sched.step()
    queued = sched.stuck_rids().get("queued", [])
    produced, requeued = sched.drain_graceful()
    drained = (sched.engine.allocator.in_use, [r.rid for r in requeued] == queued)
    sched = kept["lagged"]
    for p in prompts:
        sched.submit(p, max_new)
    sched.step()
    sched.dispatch_tick()  # a tick in flight
    sched.abandon()
    try:
        sched.submit(prompts[0], max_new)
        refused = False
    except RuntimeError:
        refused = True
    abandoned = (sched.engine.allocator.in_use, refused)
    print(f"(c) lifecycle: drain_graceful with {len(queued)} queued: requeued exactly them "
          f"{drained[1]}, blocks in use after {drained[0]}; abandon with a tick in flight: "
          f"blocks in use after {abandoned[0]}, the next submit refused {abandoned[1]}")
    if drained != (0, True) or not queued or abandoned != (0, True):
        problems.append(f"drain_graceful {drained} ({len(queued)} queued), abandon "
                        f"{abandoned}")
    del kept, sched
    empty_cache(torch, dev)

    # the dense path: the batcher in both layouts, generate_ragged, the recipe.
    # Each logits row a request's token was drawn from is held against the
    # full causal forward of its prompt and stream (the plain model, no cache)
    def forward_rows(model, prompt, stream):
        return full_forward_rows(torch, model, prompt, stream, dev)

    plain = plain_model(torch, cfg, state, dev)

    slots = serve_kw["n_slots"]
    batch = {}
    for layout in ("dense", "paged"):
        kw = {"block_len": serve_kw["block_len"]} if layout == "paged" else {}
        b = ContinuousBatcher(cfg, state, n_slots=slots,
                              prefill_bucket=serve_kw["prefill_chunk"], cache_layout=layout,
                              device=dev, **kw)
        sync(torch, dev)
        paged_flash.reset_launch_counts()
        owner, streams, rows, ticks = {}, {}, {}, []
        pending = list(range(len(prompts)))
        while pending or (b.remaining > 0).any():
            while pending and b.free_slots():
                i = pending.pop(0)
                slot = b.submit(prompts[i], max_new)
                owner[slot] = i
                rows[i] = [b.logits[slot].float().clone()]
            t0 = time.perf_counter()
            events = b.step()  # the tokens are on the host when it returns
            ticks.append(time.perf_counter() - t0)
            for slot, tok in events:
                streams.setdefault(owner[slot], []).append(tok)
                if b.remaining[slot]:
                    rows[owner[slot]].append(b.logits[slot].float().clone())
        launches = dict(paged_flash.launch_counts)
        cache_bytes = sum(t.numel() * t.element_size() for layer in b.cache for t in layer
                          if t is not None)
        del b
        err = max((torch.stack(rows[i]) - forward_rows(plain, prompts[i], streams[i]))
                  .abs().max().item() for i in range(len(prompts)))
        batch[layout] = ([streams[i] for i in range(len(prompts))], float(np.median(ticks)),
                         launches, cache_bytes, err)
        del rows
        empty_cache(torch, dev)
    del plain
    d, p = batch["dense"], batch["paged"]
    print(f"(c) lifecycle: ContinuousBatcher dense vs paged, {slots} slots, {len(prompts)} "
          f"requests x {max_new} tokens on {card}: tick p50 {d[1] * 1e3:.3f} vs "
          f"{p[1] * 1e3:.3f} ms; every logits row a token was drawn from against the full "
          f"causal forward, max_abs_err {d[4]:.4f} vs {p[4]:.4f} (limit {DECODE_TOL['bf16']}); "
          f"greedy match {match_rate(d[0], p[0]):.3f}, dense cache {d[3]} bytes, paged "
          f"launches {p[2]}")
    # the kernels launch on the card; on the CPU the wrappers run the plain version
    sweep, split = p[2].get(paged_flash.SWEEP, 0), p[2].get(paged_flash.SPLIT, 0)
    if (not max(d[4], p[4]) <= DECODE_TOL["bf16"] or (dev == "cuda" and 0 in (sweep, split))
            or any(len(x) != max_new for x in d[0] + p[0])):
        problems.append(f"the batcher: logits max_abs_err dense {d[4]}, paged {p[4]}, paged "
                        f"sweep {sweep} and split {split} launches")
    out["batcher"] = {"dense_tick_p50_s": d[1], "paged_tick_p50_s": p[1],
                      "dense_max_abs_err": d[4], "paged_max_abs_err": p[4],
                      "greedy_match": match_rate(d[0], p[0]), "dense_cache_bytes": d[3]}

    # generate_ragged: in bf16 against per-request generate (greedy match);
    # in fp32 its tokens are the argmax of the logits its prefill and
    # per-request decode steps give, and those match the fp32 full forward
    four = prompts[:4]
    lengths = [len(q) for q in four]
    padded = np.zeros((4, max(lengths)), np.int32)
    for i, q in enumerate(four):
        padded[i, :len(q)] = q
    ragged = generate_ragged(cfg, state, padded, lengths, 16, device=dev).cpu().numpy()
    alone = [generate(cfg, state, q[None], 16, device=dev)[0, len(q):].cpu().numpy()
             for q in four]
    ragged_match = match_rate([list(r) for r in ragged], [list(a) for a in alone])
    drawn, err32, same32 = ragged_fp32(torch, cfg, state, four, 16, dev)
    print(f"(c) lifecycle: generate_ragged, prompts {lengths} x 16 tokens: bf16 greedy match "
          f"with per-request generate {ragged_match:.3f}; fp32: tokens the argmax of its "
          f"prefill and decode steps' logits {drawn}, those logits against the full causal "
          f"forward max_abs_err {err32:.2e} (limit {DECODE_TOL['fp32']}), tokens equal to "
          f"per-request generate's {same32}")
    if (ragged.shape != (4, 16) or not ((ragged >= 0) & (ragged < cfg.vocab_size)).all()
            or not drawn or not err32 <= DECODE_TOL["fp32"] or not same32):
        problems.append(f"generate_ragged gave {ragged.shape}; fp32: drawn {drawn}, "
                        f"max_abs_err {err32}, equal to generate {same32}")
    out["ragged_match"] = ragged_match
    out["ragged_fp32"] = {"max_abs_err": err32, "drawn": drawn, "equal_to_generate": same32}
    empty_cache(torch, dev)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytorch_distributed_tpu_torch.recipes.serve_lm",
                        *recipe_argv], capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    recipe_s = time.perf_counter() - t0
    try:
        recipe = json.loads(r.stdout[r.stdout.index("{"):])
    except ValueError:
        recipe = {}
    print(f"(c) lifecycle: serve_lm {' '.join(recipe_argv)}: exit {r.returncode} in "
          f"{recipe_s:.1f}s, layout {recipe.get('layout')}, {recipe.get('completed')} "
          f"requests, {recipe.get('tokens_out')} tokens, serve wall {recipe.get('wall_s')}")
    if r.returncode != 0 or recipe.get("layout") != "dense" or not recipe.get("tokens_out"):
        problems.append(f"serve_lm --dense: exit {r.returncode}: {r.stderr[-2000:]}")
    out["recipe"] = {k: recipe.get(k) for k in ("completed", "tokens_out", "wall_s")}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"(c) lifecycle phase: {out['wall_s']:.1f} s")
    if problems:
        raise SystemExit(f"chip_smoke: the lifecycle phase failed: {problems}")
    return out


@contextlib.contextmanager
def counted_syncs(torch, dev, syncs: list):
    """The host syncs PyTorch's sync debug mode reports inside the block
    (``.item()``, ``.cpu()``, ``.tolist()`` of a device tensor, a blocking
    copy, ``torch.cuda.synchronize()``; an event's own wait is not one),
    appended to ``syncs``, each as the innermost ``file:line`` of the port
    or this script on its stack; on the CPU none."""
    if dev != "cuda":
        yield
        return

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]  # not this frame
                if "pytorch_distributed_tpu_torch" in f.filename or "chip_smoke" in f.filename]
        where = ours[-1] if ours else None
        syncs.append(f"{os.path.basename(filename)}:{lineno}" if where is None else
                     f"{os.path.basename(where.filename)}:{where.lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)


def record_prefill(torch, router, timed=False):
    """Per rid, the ``(bucket, start)`` of every prefill chunk it rode on
    any replica (``serve_record``'s rule: two serves of a request whose
    chunks rode the same buckets agree bit for bit); and with ``timed``, on
    the card, a pair of CUDA events around every program's replay
    (``PagedEngine._run``, after its inputs are staged), on the stream the
    programs run on, so the pairs never overlap: summed after a sync, the
    card's busy time, less its input and token copies, plus the few
    microseconds between an event on an idle stream and the replay after
    it. Returns ``(record, pairs)``. The wrappers hold the schedulers
    weakly."""
    rec, pairs = {}, []
    timed = timed and router.replicas[0].engine.device.type == "cuda"

    def timing(fn, *args):
        if not timed:
            return fn(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args)
        e1.record()
        pairs.append((e0, e1))
        return out

    for sched in router.replicas:
        cls, ref = type(sched.engine), weakref.ref(sched)

        def chunks(jobs, ref=ref, cls=cls):
            s = ref()
            bucket = s.engine.bucket_for(jobs)
            for j in jobs:
                rec.setdefault(s.resident[j.slot].rid, []).append((bucket, j.start))
            return cls.run_chunks(s.engine, jobs)

        sched.engine.run_chunks = chunks
        if timed:
            def run(prog, body, ref=ref, cls=cls):
                return timing(cls._run, ref().engine, prog, body)

            sched.engine._run = run
    return rec, pairs


def record_handoffs(torch, router) -> list:
    """Hold every handoff byte for byte: each export's blocks (every pool
    tensor, scales included) and logits row against the source pool's
    chain as it stands, and each import's chain and logits row in the
    target pool against the export. Appends one bool a handoff
    (export and import both equal)."""
    checks, pending = [], {}

    def same(a, b):
        return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8),
                                                  b.contiguous().view(torch.uint8))

    def rows(eng, slot):
        idx = torch.as_tensor(eng.allocator.chain(slot), dtype=torch.long, device=eng.device)
        return [t[idx] for layer in eng.cache for t in layer if t is not None]

    def flat(export):
        return [b for layer in export.blocks for b in layer if b is not None]

    for sched in router.replicas:
        cls, ref = type(sched.engine), weakref.ref(sched.engine)
        if sched.prefill_only:
            def export(slot, ref=ref, cls=cls):
                eng = ref()
                ex = cls.export_chain(eng, slot)
                pending[id(ex)] = (all(same(a, b) for a, b in zip(rows(eng, slot), flat(ex)))
                                   and same(eng.logits[slot], ex.logits_row))
                return ex

            sched.engine.export_chain = export
        else:
            def imp(slot, ex, ref=ref, cls=cls):
                eng = ref()
                ok = cls.import_chain(eng, slot, ex)
                if ok:
                    checks.append(pending.pop(id(ex)) and all(
                        same(a, b) for a, b in zip(rows(eng, slot), flat(ex)))
                        and same(eng.logits[slot], ex.logits_row))
                return ok

            sched.engine.import_chain = imp
    return checks


def fleet_runs(torch, card, cfg, state, prompts, serve_kw, *, kill_tick=40, recipes,
               dev="cuda") -> dict:
    """(c) the serving fleet (``fleet.FleetRouter``, two replicas on the
    card sharing its weights, each warmed up, kernels 7-9 in every
    replica's graphs) and its HTTP front door. Fails the run on any
    difference.

    1. The requests in 4 sessions through two mixed replicas by the
       synchronous loop and the lagged one (``async_host``): streams,
       placement and decisions bit-equal, every allocator empty after,
       no graph captured; each loop's fleet step and tick p50, tok/s and
       TTFT, and the host syncs a fleet step (PyTorch's sync debug mode:
       none in the lagged loop, or it waits for the other replica); the
       launch counts of the synchronous serve (``launches``).
    2. Disaggregated, 1 prefill + 1 decode, on bf16 and on fp8 pools: every
       handoff byte-equal (``record_handoffs``), one a request, their p50;
       on bf16 the streams against the colocated fleet's, bit-equal for
       every request whose chunks rode the same buckets, a match rate over
       all; on fp8 the append route's launches (``fp8_launches``).
    3. A seeded trace (``FLEET_TRACE``, ``FLEET_TRACE_N`` requests clamped
       to ``max_seq_len``) replayed at ``FLEET_TICK_S`` under depth-only
       SLOs (``FLEET_SLO``) by both loops: spills and at least one shed,
       each loop's decisions those of its CPU twin, the same sheds in both,
       and bit-equal streams where the chunks rode the same buckets.
    4. The failure plane: ``serve.dispatch`` raising on replica 1 at its
       ``kill_tick``-th and next tick (``fail_threshold`` 2) condemns it;
       it is left with no block, its requests are re-dispatched and finish
       with the tokens delivered before its death unchanged, the others
       bit-equal to the fault-free serve where their chunks rode the same
       buckets; then ``revive(1)`` behind warmup, and the survivor captures
       no graph while both serve new requests. A ``hang`` past
       ``tick_deadline_s`` condemns its replica and every request
       finishes. ``serve.handoff_export`` and ``serve.handoff_import`` fire
       once each in a disaggregated fleet: nothing fails, nothing leaks.
    5. ``gateway.Gateway`` on 127.0.0.1 over a lagged 2-replica fleet: 4
       requests streamed one after another equal to the in-process
       fleet's, a lapsed deadline a 429 with ``Retry-After``, a mid-stream
       disconnect a cancel with no block left, ``/v1/health`` and
       ``/metrics``; then ``recipes`` (``{label: argv}``) of ``serve_lm``
       each in a process of its own to exit 0, the ``--http-port`` one
       answering one request through ``gateway.client``."""
    from pytorch_distributed_tpu_torch.fleet import (
        FleetRouter,
        SLOConfig,
        clamp_trace,
        generate_trace,
        prompt_for,
        replay_trace,
    )
    from pytorch_distributed_tpu_torch.gateway import (
        Gateway,
        generate,
        health,
        metrics_text,
        open_stream,
    )
    from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
    from pytorch_distributed_tpu_torch.ops import paged_flash
    from pytorch_distributed_tpu_torch.resilience import faults
    from pytorch_distributed_tpu_torch.serving.kv_pool import kv_pool_dtype

    t_phase = time.perf_counter()
    max_new = 32
    out, problems = {}, []

    def fleet(**over):
        router = FleetRouter(cfg, state, gather_impl="kernel",
                             **{"n_replicas": 2, **serve_kw, **over})
        router.warmup()
        return router

    def launches():
        return {k: v for counts in (paged_flash.launch_counts, paged_flash.quant_launch_counts,
                                    paged_flash.route_launch_counts)
                for k, v in counts.items() if v}

    def left(router):
        return [s.engine.allocator.in_use for s in router.replicas]

    def done(router):
        router.close()
        del router
        empty_cache(torch, dev)

    def drive(router, reqs, sessions=4, after_step=None, syncs=None):
        """Submit ``reqs`` (session i % ``sessions``) and step to idle:
        rids, the serve's wall and each step's wall; with ``syncs`` (a
        list), the host syncs of the steps appended to it."""
        rids = [router.submit(p, max_new, session=i % sessions) for i, p in enumerate(reqs)]
        walls = []
        t0 = time.perf_counter()
        with counted_syncs(torch, dev, [] if syncs is None else syncs):
            while not router.idle:
                t = time.perf_counter()
                router.step()
                walls.append(time.perf_counter() - t)
                if after_step is not None:
                    after_step(router)
            router.drain()
        sync(torch, dev)
        return rids, time.perf_counter() - t0, walls

    def decisions(router):
        m = router.metrics()
        return (dict(router.placement), dict(router.rejected),
                {k: m[k] for k in ("submitted", "shed", "spilled", "handoffs", "preempt_routes",
                                   "completed")})

    def complete(router, rids, budget=max_new):
        return all(len(router.results.get(r, ())) == budget for r in rids)

    # 1. one replica and two mixed replicas by the synchronous loop and the
    # lagged one, in turns (one, sync, async, async, sync, one) after a
    # throwaway serve (the process's first serve pays one-off costs)
    runs = {}
    for loop in ("warm", "one", "sync", "async", "async", "sync", "one"):
        router = fleet(n_replicas=1 if loop == "one" else 2, async_host=loop == "async")
        rec, pairs = record_prefill(torch, router, timed=True)
        captures = [s.engine.captures for s in router.replicas]
        sync(torch, dev)
        paged_flash.reset_launch_counts()
        syncs = []
        rids, wall, walls = drive(router, prompts, syncs=syncs)
        m = router.metrics()
        ticks = [v for s in router.replicas for v in s.tick_lat.values]
        busy = sum(e0.elapsed_time(e1) for e0, e1 in pairs) / 1e3 / wall if pairs else None
        r = {
            "streams": [router.results[r] for r in rids], "decisions": decisions(router),
            "launches": launches(), "left": left(router), "record": rec,
            "captured": sum(s.engine.captures for s in router.replicas) - sum(captures),
            "complete": complete(router, rids), "step_p50_s": float(np.median(walls)),
            "tick_p50_s": float(np.median(ticks)), "tok_per_s": m["tokens_out"] / wall,
            "ttft_p50_s": m["ttft_p50_s"], "ttft_p95_s": m["ttft_p95_s"], "steps": len(walls),
            "syncs_per_step": len(syncs) / len(walls), "sync_sites": sorted(set(syncs)),
            "busy_events": busy,
            "replica_tokens": [m[f"r{i}_tokens_out"] for i in range(len(router.replicas))]}
        runs.setdefault(loop, []).append(r)
        done(router)
        busy = "not measured" if busy is None else f"{busy:.3f}"
        print(f"(c) fleet: {'1 replica' if loop == 'one' else '2 mixed replicas'}, "
              f"{'lagged' if loop == 'async' else 'synchronous'} loop"
              f"{', the throwaway serve' if loop == 'warm' else ''}, on {card}: "
              f"{len(prompts)} requests x {max_new} tokens in 4 sessions: {r['steps']} steps, "
              f"step p50 {r['step_p50_s'] * 1e3:.3f} ms, replica tick p50 "
              f"{r['tick_p50_s'] * 1e3:.3f} ms, {r['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{r['ttft_p50_s'] * 1e3:.1f} ms p95 {r['ttft_p95_s'] * 1e3:.1f} ms, busy (CUDA "
              f"events around every replay) {busy}; host syncs a step "
              f"{r['syncs_per_step']:.4f} at {r['sync_sites']}; tokens by replica "
              f"{r['replica_tokens']}; blocks left {r['left']}; graphs captured while serving "
              f"{r['captured']}")
    del runs["warm"]
    flat = [r for rs in runs.values() for r in rs]
    o_, s_, a_ = runs["one"][0], runs["sync"][0], runs["async"][0]
    print(f"(c) fleet: synchronous vs lagged loop: streams equal "
          f"{all(r['streams'] == s_['streams'] for r in runs['sync'] + runs['async'])}, "
          f"placement and decisions equal "
          f"{all(r['decisions'] == s_['decisions'] for r in runs['sync'] + runs['async'])}; "
          f"launches {s_['launches']}")
    bf16 = (paged_flash.SWEEP, paged_flash.SPLIT)
    if (any(r["streams"] != s_["streams"] or r["decisions"] != s_["decisions"]
            for r in runs["sync"] + runs["async"])
            or any(r["streams"] != o_["streams"] for r in runs["one"])
            or any(any(r["left"]) or r["captured"] or not r["complete"] for r in flat)
            or any(r["syncs_per_step"] for r in flat)
            or (dev == "cuda" and not all(s_["launches"].get(k, 0) for k in bf16))
            or 0 in s_["replica_tokens"]):
        problems.append(f"the 2-replica fleet: loops equal {s_['streams'] == a_['streams']}, "
                        f"decisions equal {s_['decisions'] == a_['decisions']}, left "
                        f"{[r['left'] for r in flat]}, captured {[r['captured'] for r in flat]}, "
                        f"syncs {[r['sync_sites'] for r in flat]}, launches {s_['launches']}")
    out["loops"] = {f"{loop}_{k}": [r[k] for r in rs] for loop, rs in runs.items()
                    for k in ("step_p50_s", "tick_p50_s", "tok_per_s", "ttft_p50_s", "ttft_p95_s",
                              "syncs_per_step", "steps", "busy_events")}
    out["launches"] = s_["launches"]

    # 2. disaggregated, 1 prefill + 1 decode, against the colocated fleet of
    # one replica above (which prefills on the same schedule until its
    # decoding lanes hold slots the prefill replica has freed): bf16 pools
    # timed, then bf16 and fp8 pools with every handoff checked
    col_rec, colocated = o_["record"], o_["streams"]
    disagg = {}
    for label, kv in (("bf16", None), ("bf16, checked", None), ("fp8, checked", "fp8")):
        router = fleet(disaggregate=True, kv_dtype=kv)
        rec = record_prefill(torch, router)[0]
        checks = record_handoffs(torch, router) if "checked" in label else None
        sync(torch, dev)
        paged_flash.reset_launch_counts()
        rids, _, _ = drive(router, prompts)
        m = router.metrics()
        disagg[label] = {"streams": [router.results[r] for r in rids], "record": rec,
                         "checks": checks, "handoffs": m["handoffs"],
                         "handoff_p50_s": m.get("handoff_p50_s"),
                         "handoff_p95_s": m.get("handoff_p95_s"), "left": left(router),
                         "complete": complete(router, rids), "launches": launches()}
        done(router)
    disagg["fp8"] = disagg.pop("fp8, checked")
    d = disagg["bf16"]
    same = [i for i in range(len(prompts)) if d["record"].get(i) == col_rec.get(i)]
    differ = [i for i in same if d["streams"][i] != colocated[i]]
    match = match_rate(d["streams"], colocated)
    dt8 = kv_pool_dtype("fp8")
    fp8_keys = [paged_flash.variant(k, dt8) for k in bf16]
    fp8_append = sum(disagg["fp8"]["launches"].get(paged_flash.append_key(k, dt8), 0) for k in bf16)
    for label, r in disagg.items():
        checked = ("unchecked" if r["checks"] is None else
                   f"{sum(r['checks'])} of {len(r['checks'])} byte-equal (blocks, scales and "
                   f"logits row, export and import; the checks inside the timed handoff)")
        print(f"(c) fleet: disaggregated 1 prefill + 1 decode, {label} pools, on {card}: "
              f"{r['handoffs']} handoffs, {checked}, handoff p50 "
              f"{(r['handoff_p50_s'] or 0.0) * 1e3:.3f} ms p95 "
              f"{(r['handoff_p95_s'] or 0.0) * 1e3:.3f} ms; blocks left {r['left']}")
        if (r["handoffs"] != len(prompts) or any(r["left"]) or not r["complete"]
                or (r["checks"] is not None
                    and (len(r["checks"]) != len(prompts) or not all(r["checks"])))):
            problems.append(f"disaggregated {label}: {r['handoffs']} handoffs, checks "
                            f"{r['checks']}, left {r['left']}")
    print(f"(c) fleet: disaggregated vs colocated (one mixed replica) streams, bf16: rids on "
          f"the same prefill "
          f"buckets {same}, of which differ {differ}; greedy match over all {match:.3f}; fp8 "
          f"launches {disagg['fp8']['launches']}")
    if differ or not same or (dev == "cuda" and not (
            all(disagg["fp8"]["launches"].get(k, 0) for k in fp8_keys) and fp8_append)):
        problems.append(f"disaggregated vs colocated: same buckets {same}, differ {differ}; fp8 "
                        f"launches {disagg['fp8']['launches']}")
    checked_streams = disagg["bf16, checked"]["streams"]
    if checked_streams != d["streams"]:
        problems.append("the checked disaggregated serve's streams differ from the timed one's")
    out["disagg"] = {"handoffs": d["handoffs"], "handoff_p50_s": d["handoff_p50_s"],
                     "handoff_p95_s": d["handoff_p95_s"], "same_buckets": same, "match": match}
    out["fp8_launches"] = disagg["fp8"]["launches"]

    # 3. a seeded trace under depth-only SLOs, both loops. Routing reads
    # queue depths and occupancy, step-domain counts, so each loop's
    # decisions are those of a CPU twin of its fleet (a narrow model of the
    # same serving geometry). The lagged loop reads each replica's
    # occupancy before its last tick is collected, so its decisions may
    # differ from the synchronous loop's (so do the JAX package's): the
    # sheds, every stream whole, and the streams of the requests whose
    # chunks rode the same buckets in both loops are held between them
    trace = clamp_trace(generate_trace(**FLEET_TRACE)[:FLEET_TRACE_N], cfg.max_seq_len,
                        serve_kw["prefill_chunk"])
    twin_cfg = dataclasses.replace(cfg, num_layers=1, embed_dim=32, num_heads=2,
                                   dtype=torch.float32)
    twin_state = params_from_jax(init_params(twin_cfg, seed=0))

    def replay(router, rec=None):
        budgets = {}

        def submit(r):
            budgets[router.submit(prompt_for(r, cfg.vocab_size), r.max_new,
                                  session=r.session)] = r.max_new

        ticks = replay_trace(trace, submit, router.step, lambda: router.idle,
                             tick_s=FLEET_TICK_S)
        router.drain()
        served = [rid for rid in budgets if rid not in router.rejected]
        return {"streams": {rid: router.results.get(rid) for rid in budgets},
                "decisions": decisions(router), "ticks": ticks, "left": left(router),
                "record": rec,
                "complete": all(len(router.results.get(rid, ())) == budgets[rid]
                                for rid in served)}

    traced, twins = {}, {}
    for loop in ("sync", "async"):
        router = fleet(slo=SLOConfig(**FLEET_SLO), async_host=loop == "async")
        traced[loop] = replay(router, record_prefill(torch, router)[0])
        done(router)
        twin = FleetRouter(twin_cfg, twin_state, n_replicas=2, slo=SLOConfig(**FLEET_SLO),
                           async_host=loop == "async", **{**serve_kw, "device": "cpu"})
        twins[loop] = replay(twin)["decisions"]
        twin.close()
    ts, ta = traced["sync"], traced["async"]
    counts = ts["decisions"][2]
    moved = sorted(rid for rid, rep in ts["decisions"][0].items()
                   if ta["decisions"][0].get(rid) != rep)
    same = sorted(rid for rid, shapes in ts["record"].items()
                  if shapes == ta["record"].get(rid))
    differ = [rid for rid in same if ts["streams"][rid] != ta["streams"][rid]]
    served = [rid for rid, st in ts["streams"].items() if st is not None]
    print(f"(c) fleet: trace of {len(trace)} requests (seed {FLEET_TRACE['seed']}, prompts up to "
          f"{max(r.prompt_len for r in trace)} tokens) at {FLEET_TICK_S} s a tick, SLO "
          f"{FLEET_SLO}, on {card}: synchronous loop {ts['ticks']} ticks, {counts}; lagged loop "
          f"{ta['ticks']} ticks, {ta['decisions'][2]}; each loop's decisions equal to its CPU "
          f"twin's {ts['decisions'] == twins['sync']} {ta['decisions'] == twins['async']}; "
          f"sheds equal between the loops {ts['decisions'][1] == ta['decisions'][1]} (reasons "
          f"{sorted(set(ts['decisions'][1].values()))}), rids placed apart {moved}; rids on the "
          f"same buckets in both {len(same)}, of which streams differ {differ}; greedy match "
          f"{match_rate(*([st[r] for r in served] for st in (ts['streams'], ta['streams']))):.3f}; "
          f"blocks left {ts['left']} {ta['left']}")
    if (ts["decisions"] != twins["sync"] or ta["decisions"] != twins["async"]
            or ts["decisions"][1] != ta["decisions"][1] or differ or not same
            or counts["spilled"] < 1 or counts["shed"] < 1 or any(ts["left"] + ta["left"])
            or not (ts["complete"] and ta["complete"])):
        problems.append(f"the trace: counts {counts} {ta['decisions'][2]}, twins equal "
                        f"{ts['decisions'] == twins['sync']} {ta['decisions'] == twins['async']}"
                        f", differ {differ}, left {ts['left']} {ta['left']}, every stream "
                        f"whole {ts['complete']} {ta['complete']}")
    out["trace"] = {**counts, "ticks": ts["ticks"], "lagged": ta["decisions"][2],
                    "placed_apart": moved}

    # 4. the failure plane: a replica killed mid-serve, revived; a hang; handoff faults
    router = fleet(fail_threshold=2, redispatch_base_delay_s=0.0)
    rec = record_prefill(torch, router)[0]
    death = {}

    def watch(router):
        if not death and router.health[1]["state"] == "dead":
            harvested = sorted(router._origin)
            death.update(step=router._tick, harvested=harvested,
                         delivered={r: list(router.results.get(r, ())) for r in harvested},
                         left=router.replicas[1].engine.allocator.in_use)

    # replica 1 dispatches the odd occurrences while both live
    plan = faults.install_plan(faults.FaultPlan([
        faults.FaultSpec(site="serve.dispatch", kind="raise", at=2 * kill_tick + 1),
        faults.FaultSpec(site="serve.dispatch", kind="raise", at=2 * kill_tick + 3)]))
    try:
        rids, _, _ = drive(router, prompts, after_step=watch)
    finally:
        faults.clear_plan()
    m = router.metrics()
    streams = [router.results[r] for r in rids]
    moved = death.get("harvested", [])
    kept = [i for i in range(len(prompts))
            if i not in moved and rec.get(i) == s_["record"].get(i)]
    prefix_ok = all(streams[r][:len(death["delivered"][r])] == death["delivered"][r]
                    and death["delivered"][r] == s_["streams"][r][:len(death["delivered"][r])]
                    for r in moved)
    kept_differ = [i for i in kept if streams[i] != s_["streams"][i]]
    fault_match = match_rate(streams, s_["streams"])
    print(f"(c) fleet: serve.dispatch raised on replica 1 at its ticks {kill_tick} and "
          f"{kill_tick + 1} (fired {len(plan.fired)}): health "
          f"{[h['state'] for h in router.health]}, condemned at step {death.get('step')} "
          f"with {death.get('left')} blocks left, rids "
          f"{moved} re-dispatched ({m['redispatched']}) after "
          f"{[len(death['delivered'][r]) for r in moved]} delivered tokens, every stream whole "
          f"{complete(router, rids)}, delivered prefixes unchanged {prefix_ok}; rids never moved "
          f"on the same buckets {kept}, of which differ {kept_differ}; greedy match with the "
          f"fault-free serve {fault_match:.3f}")
    if (len(plan.fired) != 2 or m["replica_deaths"] != 1 or router.health[1]["state"] != "dead"
            or death.get("left") != 0 or not moved or not prefix_ok or kept_differ
            or not complete(router, rids) or m["failed"] or any(left(router))):
        problems.append(f"the killed replica: fired {plan.fired}, deaths {m['replica_deaths']}, "
                        f"death {death.get('step')} left {death.get('left')}, moved {moved}, "
                        f"prefixes {prefix_ok}, differ {kept_differ}")
    survivor = router.replicas[0].engine.captures
    router.revive(1)
    revived = router.replicas[1].engine.captures
    more = [router.submit(p, max_new, session=100 + i) for i, p in enumerate(prompts[:4])]
    router.drain()
    counts_after = (router.replicas[0].engine.captures - survivor,
                    router.replicas[1].engine.captures - revived)
    revived_served = router.replicas[1].metrics()["completed"]
    router.assert_registry_covers()
    print(f"(c) fleet: revive(1) behind warmup: health {[h['state'] for h in router.health]}, "
          f"{revived} graphs on the revived replica, graphs captured since by the survivor and "
          f"the revived one {counts_after}, requests the revived one served {revived_served}, "
          f"new streams whole {complete(router, more)}; blocks left {left(router)}")
    if (counts_after != (0, 0) or revived_served < 1 or not complete(router, more)
            or any(left(router)) or router.health[1]["state"] != "healthy"):
        problems.append(f"revive: captured {counts_after}, served {revived_served}")
    done(router)
    router = fleet(tick_deadline_s=FLEET_HANG["tick_deadline_s"], redispatch_base_delay_s=0.0)
    plan = faults.install_plan(faults.FaultPlan([faults.FaultSpec(
        site="serve.dispatch", kind="hang", at=2, seconds=FLEET_HANG["seconds"])]))
    try:
        rids, _, _ = drive(router, prompts[:8])
    finally:
        faults.clear_plan()
    hang = ([h["state"] for h in router.health], complete(router, rids), left(router))
    print(f"(c) fleet: a {FLEET_HANG['seconds']} s hang at replica 0's second tick, tick "
          f"deadline {FLEET_HANG['tick_deadline_s']} s: health {hang[0]}, every stream whole "
          f"{hang[1]}, blocks left {hang[2]}")
    if len(plan.fired) != 1 or hang[0] != ["dead", "healthy"] or not hang[1] or any(hang[2]):
        problems.append(f"the hang: fired {plan.fired}, {hang}")
    done(router)
    router = fleet(disaggregate=True)
    sites = ("serve.handoff_export", "serve.handoff_import")
    plan = faults.install_plan(faults.FaultPlan([faults.FaultSpec(site=site, kind="raise")
                                                 for site in sites]))
    try:
        rids, _, _ = drive(router, prompts[:8])
    finally:
        faults.clear_plan()
    hf = (sorted(site for site, _, _ in plan.fired), [h["state"] for h in router.health],
          sum(h["failures"] for h in router.health), complete(router, rids), left(router))
    print(f"(c) fleet: serve.handoff_export and serve.handoff_import raised once each in the "
          f"disaggregated fleet: fired {hf[0]}, health {hf[1]}, failures {hf[2]}, every stream "
          f"whole {hf[3]}, blocks left {hf[4]}")
    if (hf[0] != sorted(sites) or hf[1] != ["healthy", "healthy"] or hf[2] != 2 or not hf[3]
            or any(hf[4])):
        problems.append(f"the handoff faults: {hf}")
    done(router)
    out["faults"] = {"moved": moved, "fault_match": fault_match, "revive_captured": counts_after}

    # 5. the gateway, then the recipes
    four = prompts[:4]
    router = fleet()
    ref = []
    for p in four:
        rid = router.submit(p, max_new)
        ref.append(router.drain()[rid])
    done(router)
    router = fleet(async_host=True, retain_results=False)
    with Gateway(router, port=0) as gw:
        base = f"http://127.0.0.1:{gw.port}"
        got = [generate(base, p, max_new) for p in four]
        lapsed = generate(base, four[0], max_new, deadline_ms=0)
        stream = open_stream(base, prompts[4][:64], 1024)
        first = next(stream.events())
        stream.close()
        t0 = time.perf_counter()
        while gw.metrics()["gateway_cancels"] < 1 and time.perf_counter() - t0 < 60:
            time.sleep(0.01)
        cancels = gw.metrics()["gateway_cancels"]
        routable = health(base)["routable"]
        text = metrics_text(base)
    router.drain()
    gleft = left(router)
    done(router)
    equal = [g["status"] == 200 and g["outcome"] == "complete" and g["tokens"] == r
             for g, r in zip(got, ref)]
    print(f"(c) fleet: the gateway over a lagged 2-replica fleet on {card}: {len(four)} streams "
          f"equal to the in-process fleet's {equal}; deadline 0 ms: {lapsed['status']} "
          f"Retry-After {lapsed.get('retry_after')} ({lapsed.get('reason')}); a disconnect "
          f"after the first event {first[0]}: cancels {cancels}; health routable {routable}; "
          f"/metrics {len(text.splitlines())} lines; blocks left {gleft}")
    if (not all(equal) or lapsed["status"] != 429 or lapsed.get("retry_after") != "1"
            or cancels < 1 or routable != 2 or "pdt_gateway_open_streams" not in text
            or any(gleft)):
        problems.append(f"the gateway: equal {equal}, lapsed {lapsed}, cancels {cancels}, "
                        f"routable {routable}, left {gleft}")
    root = os.path.dirname(os.path.abspath(__file__))
    out["recipes"] = {}
    for label, argv in recipes.items():
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m",
                                 "pytorch_distributed_tpu_torch.recipes.serve_lm", *argv],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                cwd=root)
        answered = None
        try:
            if "--http-port" in argv:
                for line in proc.stdout:
                    if line.startswith("gateway: "):
                        url = line.split()[1].rsplit("/v1/", 1)[0]
                        answered = generate(url, [5, 6, 7, 8], 3)
                        break
            text, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        try:
            metrics = json.loads(text[text.index("{\n"):])
        except ValueError:
            metrics = {}
        out["recipes"][label] = {"exit": proc.returncode, "s": time.perf_counter() - t0,
                                 "completed": metrics.get("completed"),
                                 "handoffs": metrics.get("handoffs")}
        print(f"(c) fleet: serve_lm {' '.join(argv)}: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f}s, layout {metrics.get('layout')}, "
              f"{metrics.get('completed')} completed, {metrics.get('handoffs')} handoffs"
              + (f", its gateway answered {answered and answered.get('outcome')}"
                 if "--http-port" in argv else ""))
        if (proc.returncode != 0 or metrics.get("layout") != "fleet"
                or ("--http-port" in argv and (answered or {}).get("outcome") != "complete")):
            problems.append(f"serve_lm {argv}: exit {proc.returncode}: {text[-2000:]}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"(c) fleet phase: {out['wall_s']:.1f} s")
    if problems:
        raise SystemExit(f"chip_smoke: the fleet phase failed: {problems}")
    return out


def _fleet_child(card, cfg, prompts, serve_kw, recipes, weights) -> dict:
    """``fleet_runs`` on the card in this (spawned) process, on the seed-0
    weights main saved to ``weights``, with main's numerics settings."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return fleet_runs(torch, card, cfg, torch.load(weights, mmap=True), prompts, serve_kw,
                      recipes=recipes)


def fleet_phase(card, cfg, prompts, serve_kw, recipes, weights) -> dict:
    """``fleet_runs`` in a process of its own, as the data phase runs (its
    profiled serves would otherwise share this process's traces)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx, max_tasks_per_child=1) as ex:
        return ex.submit(_fleet_child, card, cfg, prompts, serve_kw, recipes, weights).result()


def fleet_line(card, fleet: dict, busy: dict) -> str:
    """The fleet's loops beside one replica's, all in the same call:
    ``fleet["loops"]`` (``fleet_runs``' host-clock and CUDA-event figures
    of one replica and of two by each loop, each run twice, in turns) and
    ``busy``, ``graph_runs``' profiled busy shares (``one_step``,
    ``one_lagged``: one scheduler's serves; ``fleet_sync``,
    ``fleet_async``)."""
    f = fleet["loops"]

    def each(key, scale=1e3, fmt=".3f"):
        return " / ".join(
            ", ".join("not measured" if v is None else format(v * scale, fmt)
                      for v in f[f"{loop}_{key}"]) for loop in ("one", "sync", "async"))

    return (f"(c) fleet vs one replica on {card}, the same 16 requests x 32 tokens in 4 "
            f"sessions, warmed-up graphs, one replica / two synchronous / two lagged (two runs "
            f"each): step p50 {each('step_p50_s')} ms, replica tick p50 {each('tick_p50_s')} "
            f"ms, tok/s {each('tok_per_s', 1, '.1f')}, TTFT p50 {each('ttft_p50_s', 1e3, '.1f')}"
            f" ms, p95 {each('ttft_p95_s', 1e3, '.1f')} ms, busy by CUDA events "
            f"{each('busy_events', 1)}, host syncs a step {each('syncs_per_step', 1, '.4f')}; "
            f"busy profiled one replica {busy['one_step']:.3f} (lagged "
            f"{busy['one_lagged']:.3f}), fleet {busy['fleet_sync']:.3f} / "
            f"{busy['fleet_async']:.3f}")


def sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def empty_cache(torch, dev):
    if dev == "cuda":
        torch.cuda.empty_cache()


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_distributed_tpu_torch.compilecache import serving_registry
    from pytorch_distributed_tpu_torch.data import SyntheticTokens, native
    from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
    from pytorch_distributed_tpu_torch.models.transformer import Dense
    from pytorch_distributed_tpu_torch.ops import _build, flash_attention, paged_flash
    from pytorch_distributed_tpu_torch.ops.attention import paged_attention_reference
    from pytorch_distributed_tpu_torch.recipes.serve_lm import full_config
    from pytorch_distributed_tpu_torch.serving import PagedEngine, Scheduler, pool_block_bytes
    from pytorch_distributed_tpu_torch.serving.engine import ChunkJob
    from pytorch_distributed_tpu_torch.serving.kv_pool import kv_pool_dtype
    from pytorch_distributed_tpu_torch.train import (
        LMTrainer,
        LMTrainerConfig,
        create_lm_state,
        lm_collate,
        make_lm_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"(a) card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- (a) build every kernel source, one nvcc each, all at once ----
    t0 = time.perf_counter()
    parallel_only = "--parallel-only" in argv
    tp_only = "--tp-only" in argv
    paths = _build.build(PARALLEL_SOURCES if parallel_only else TP_SOURCES if tp_only
                         else _build.kernel_sources())
    print(f"(a) built {sorted(paths)} in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    print(f"(a) built the native record reader {native.build().name} with g++ in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"    ptxas {name}: {line.strip()}")

    if parallel_only:
        in_child(parallel_runs, card, recipes=False)
        print(f"(c) --parallel-only: stopping after {time.perf_counter() - t_start:.1f}s")
        return 0
    if tp_only:
        in_child(tp_runs, card)
        print(f"(c) --tp-only: stopping after {time.perf_counter() - t_start:.1f}s")
        return 0

    # ---- (b) kernels against the plain version on the card ----
    failures = []

    def check(label, got, want, tol):
        return check_abs(torch, failures, label, got, want, tol)

    def check_split_repeat(label, inp, split_s):
        """The split's output of two launches, bit for bit (its merge sums
        the workers' partials in a fixed order)."""
        check_repeat(torch, failures, f"{label}, split", (
            paged_flash.paged_flash_attention(**inp, split_s=split_s),),
            (paged_flash.paged_flash_attention(**inp, split_s=split_s),))

    bf16, f32 = torch.bfloat16, torch.float32
    decode_bf16 = decode_inputs(torch, bf16)
    ref_decode = paged_attention_reference(**decode_bf16)
    errs = {
        paged_flash.SWEEP: check(
            "decode B=8 C=1 H=12 D=64 W=128 bf16, sweep",
            paged_flash.paged_flash_attention(**decode_bf16, split_s=1),
            ref_decode, BF16_TOL),
        paged_flash.SPLIT: check(
            "decode B=8 C=1 H=12 D=64 W=128 bf16, auto split (S=8)",
            paged_flash.paged_flash_attention(**decode_bf16), ref_decode, BF16_TOL),
    }
    # q as the fused qkv projection hands it over: a view, read through strides
    strided = dict(decode_bf16, q=torch.stack([decode_bf16["q"]] * 3, dim=2)[:, :, 1])
    for split_s in (1, None):
        check(f"decode bf16, q a strided view, split_s={split_s}",
              paged_flash.paged_flash_attention(**strided, split_s=split_s),
              ref_decode, BF16_TOL)
    # the bf16 split (paged_split_tc_kernel): repeatable, and at a forced 16
    # workers (spans of 8 blocks: two ring stages each)
    check_split_repeat("decode B=8 C=1 H=12 D=64 W=128 bf16, auto split", decode_bf16, None)
    check_split_repeat("decode bf16, q a strided view, auto split", strided, None)
    check("decode B=8 C=1 H=12 D=64 W=128 bf16, split_s=16",
          paged_flash.paged_flash_attention(**decode_bf16, split_s=16), ref_decode, BF16_TOL)
    check_split_repeat("decode bf16, split_s=16", decode_bf16, 16)
    decode_f32 = decode_inputs(torch, f32, seed=1)
    ref32 = paged_attention_reference(**decode_f32)
    sweep32 = paged_flash.paged_flash_attention(**decode_f32, split_s=1)
    split32 = paged_flash.paged_flash_attention(**decode_f32)
    check("decode fp32, sweep", sweep32, ref32, FP32_TOL)
    check("decode fp32, auto split", split32, ref32, FP32_TOL)
    check("decode fp32, split vs sweep", split32, sweep32, SPLIT_VS_SWEEP_TOL)
    chunk = prefill_inputs(torch, bf16)
    ref_chunk = paged_attention_reference(**chunk)
    for split_s in (1, None):
        check(f"prefill chunk B=4 C=32 W=64 bf16, split_s={split_s}",
              paged_flash.paged_flash_attention(**chunk, split_s=split_s),
              ref_chunk, BF16_TOL)
    # GQA (4 query heads per KV head), padding rows (-1) and a fully masked
    # row, R = G*C = 20 rows: two row tiles per KV head
    pos = np.array([[40, 41, 42, 43, 44], [3, 9, -1, -1, -1], [-1] * 5])
    for dtype, tol in ((bf16, BF16_TOL), (f32, FP32_TOL)):
        gqa = decode_inputs(torch, dtype, b=3, c=5, h=8, h_kv=2, w=8, seed=3,
                            positions=pos)
        ref = paged_attention_reference(**gqa)
        for split_s in (1, 3):
            check(f"GQA H=8 H_kv=2 C=5 padding rows {dtype}, split_s={split_s}",
                  paged_flash.paged_flash_attention(**gqa, split_s=split_s), ref, tol)
        check_split_repeat(f"GQA H=8 H_kv=2 C=5 padding rows {dtype}", gqa, 3)
    # R = G*C = 80 rows per KV head: two tensor-core row tiles (64 + 16)
    # and ten CUDA-core ones; a long chain, padding rows, a fully masked
    # batch row
    pos = np.full((3, 20), -1)
    pos[0] = 180 + np.arange(20)
    pos[1, :7] = 40 + np.arange(7)
    for dtype, tol in ((bf16, BF16_TOL), (f32, FP32_TOL)):
        many = decode_inputs(torch, dtype, b=3, c=20, h=8, h_kv=2, w=16, seed=9,
                             positions=pos)
        ref = paged_attention_reference(**many)
        for split_s in (1, 3):
            check(f"GQA H=8 H_kv=2 C=20 (R=80, {paged_flash.tc_row_tiles(80)} tensor-core row "
                  f"tiles) padding rows {dtype}, split_s={split_s}",
                  paged_flash.paged_flash_attention(**many, split_s=split_s), ref, tol)
        check_split_repeat(f"GQA H=8 H_kv=2 C=20 (R=80) padding rows {dtype}", many, 3)
    for dtype, tol in ((bf16, BF16_TOL), (f32, FP32_TOL)):
        wide = decode_inputs(torch, dtype, b=2, c=2, h=2, h_kv=2, d=128, w=8, seed=4)
        check(f"D=128 {dtype}, split_s=2", paged_flash.paged_flash_attention(**wide, split_s=2),
              paged_attention_reference(**wide), tol)
        check_split_repeat(f"D=128 {dtype}", wide, 2)

    # the quantized pools, quantized by the plain quantize_kv: bf16 q runs
    # the tensor-core kernels (codes widened in the products, scales outside
    # them), fp32 q the CUDA-core walk, which dequantizes to fp32
    decode_q, chunk_q = {}, {}
    for kv in QUANT:
        for dtype, tol in ((bf16, BF16_TOL), (f32, FP32_TOL)):
            for label, decode in (("decode B=8 C=1 H=12 D=64 W=128", True),
                                  ("prefill chunk B=4 C=32 W=64", False)):
                raw = (decode_inputs(torch, f32, seed=5) if decode
                       else prefill_inputs(torch, f32, seed=5))
                inp = quantized(torch, raw, kv)
                inp["q"] = inp["q"].to(dtype)
                ref = paged_attention_reference(**inp)
                route = paged_flash.sweep_kernel(dtype, inp["k_pool"].dtype, 64, 16)
                for name, split_s in ((paged_flash.SWEEP, 1), (paged_flash.SPLIT, None)):
                    err = check(f"{label} {kv} pools, {dtype} q, {name} ({route})",
                                paged_flash.paged_flash_attention(**inp, split_s=split_s),
                                ref, tol)
                    if dtype == bf16 and decode:
                        errs[paged_flash.variant(name, inp["k_pool"].dtype)] = err
                if dtype == bf16:
                    check_split_repeat(f"{label} {kv} pools, bf16 q, auto split", inp, None)
                    (decode_q if decode else chunk_q)[kv] = inp
        # the shapes the bf16 tensor-core route is held at: GQA with padding
        # and fully masked rows (R = 20), R = 80 (two sweep row tiles, three
        # split ones), D = 128
        shapes = (
            ("GQA H=8 H_kv=2 C=5 padding rows", (1, 3), dict(
                b=3, c=5, h=8, h_kv=2, w=8, seed=3,
                positions=np.array([[40, 41, 42, 43, 44], [3, 9, -1, -1, -1], [-1] * 5]))),
            ("GQA H=8 H_kv=2 C=20 (R=80) padding rows", (1, 3), dict(
                b=3, c=20, h=8, h_kv=2, w=16, seed=9,
                positions=np.stack([180 + np.arange(20), np.r_[40 + np.arange(7), [-1] * 13],
                                    np.full(20, -1)]))),
            ("D=128", (1, 2), dict(b=2, c=2, h=2, h_kv=2, d=128, w=8, seed=4)))
        for label, splits, shape in shapes:
            inp = quantized(torch, decode_inputs(torch, f32, **shape), kv)
            inp["q"] = inp["q"].to(bf16)
            ref = paged_attention_reference(**inp)
            for split_s in splits:
                check(f"{label} {kv} pools, bf16 q, split_s={split_s}",
                      paged_flash.paged_flash_attention(**inp, split_s=split_s), ref, BF16_TOL)
            check_split_repeat(f"{label} {kv} pools, bf16 q", inp, splits[-1])

    # the GQA + RoPE model's geometry (slice 18): H 12 over H_kv 4 (G = 3),
    # D 64, bf16 q; the decode tick (R = G·C = 3) and the prefill chunk (R =
    # 96: two tensor-core row tiles), on bf16 and fp8 pools; each split
    # twice, bit for bit
    g3 = {}
    for shape, raw in (("decode", decode_inputs(torch, f32, h_kv=4, seed=21)),
                       ("prefill chunk", prefill_inputs(torch, f32, seed=22, h_kv=4))):
        for kv in ("bf16", "fp8"):
            inp = (dict(raw, k_pool=raw["k_pool"].to(bf16), v_pool=raw["v_pool"].to(bf16))
                   if kv == "bf16" else quantized(torch, raw, kv))
            inp["q"] = inp["q"].to(bf16)
            ref = paged_attention_reference(**inp)
            label = f"G=3 {shape} H=12 H_kv=4 D=64 {kv} pools, bf16 q"
            for name, split_s in ((paged_flash.SWEEP, 1), (paged_flash.SPLIT, None)):
                check(f"{label}, {name}",
                      paged_flash.paged_flash_attention(**inp, split_s=split_s), ref, BF16_TOL)
            check_split_repeat(label, inp, None)
            g3[(shape, kv)] = inp

    # quantize-on-scatter: bit-equal to the plain version (the trash block,
    # where the dead lane's rows land in no fixed order, aside)
    for kv in QUANT:
        for dtype in (bf16, f32):
            for label, (b_, l_) in (("chunk 8 jobs x 32 rows", (8, 32)), ("decode 8 rows", (8, 1))):
                args = scatter_inputs(torch, kv, dtype, b=b_, l=l_, seed=6)
                mine = [t.clone() for t in args[4:]]
                plain = [t.clone() for t in args[4:]]
                paged_flash.paged_quantize_scatter(*args[:4], *mine)
                paged_flash.paged_quantize_scatter_reference(*args[:4], *plain)
                torch.cuda.synchronize()
                n_diff = sum(int((x[1:].view(torch.uint8) != y[1:].view(torch.uint8)).sum())
                             for x, y in zip(mine, plain))
                print(f"(b) quantize-on-scatter {label} {dtype} into {kv}: "
                      f"{'bit-equal' if n_diff == 0 else f'{n_diff} bytes DIFFER'}")
                if n_diff:
                    failures.append(f"quantize-on-scatter {label} {dtype} {kv}")
                if dtype == bf16 and l_ == 1:  # bit-equal, or the run stops below
                    errs[paged_flash.variant(paged_flash.QUANTIZE, mine[0].dtype)] = 0.0
    # the same rows quantized and written by the tensor-core sweep and split
    # themselves (the append route)
    append_errs = check_append_route(torch, failures)

    FWD, BWD = flash_attention.FWD, flash_attention.BWD

    def check_flash(label, dtype, tol_o, tol_g, causal=True, shift=0, **shape):
        """Both flash kernels against their plain versions; the backward
        takes the plain forward's O and LSE, as both sides must see the
        same inputs. Returns the largest error of each kernel."""
        q, k, v, do = flash_inputs(torch, dtype, **shape)
        sc = q.shape[-1] ** -0.5
        o, lse = flash_attention.launch_forward(q, k, v, causal, sc, shift)
        ro, rlse = flash_attention.flash_forward_reference(q, k, v, causal=causal,
                                                           scale=sc, shift=shift)
        err_o = check(f"flash fwd O, {label}", o, ro, tol_o)
        check(f"flash fwd LSE, {label}", lse, rlse, LSE_TOL)
        grads = flash_attention.launch_backward(q, k, v, ro, rlse, do, causal, sc, shift)
        check_repeat(torch, failures, f"flash bwd, {label}", grads,
                     flash_attention.launch_backward(q, k, v, ro, rlse, do, causal, sc, shift))
        want = flash_attention.flash_backward_reference(q, k, v, ro, rlse, do,
                                                        causal=causal, scale=sc, shift=shift)
        err_g = max(check(f"flash bwd {n}, {label}", g, w, tol_g)
                    for n, g, w in zip(("dQ", "dK", "dV"), grads, want))
        if shift < 0 and not ((o[:, :-shift] == 0).all() and (grads[0][:, :-shift] == 0).all()
                              and (lse[:, :, :-shift] == -1e30).all()):
            failures.append(f"fully masked rows, {label}")
        return {FWD: err_o, BWD: err_g}

    flash_errs = check_flash("training shape B=8 L=2048 H=12 D=64 causal bf16", bf16,
                             BF16_TOL, BF16_GRAD_TOL)
    for causal in (True, False):
        check_flash(f"ragged L=300 fp32 causal={causal}", f32, FP32_TOL, FP32_TOL,
                    causal=causal, b=2, l=300, h=2, seed=1)
    check_flash("Lq=90 Lk=200 fp32 not causal", f32, FP32_TOL, FP32_TOL, causal=False,
                b=2, l=90, lk=200, h=2, seed=2)
    for dtype, tol_o, tol_g in ((bf16, BF16_TOL, BF16_GRAD_TOL), (f32, FP32_TOL, FP32_TOL)):
        check_flash(f"D=128 L=130 causal {dtype}", dtype, tol_o, tol_g, b=2, l=130, h=2,
                    d=128, seed=3)
        check_flash(f"rows 0-36 fully masked (shift -37) {dtype}", dtype, tol_o, tol_g,
                    shift=-37, b=1, l=100, h=2, seed=4)
    tail_errs = check_tail_kernels(torch, failures)
    split_errs = check_split_kernels(torch, failures)
    if failures:
        raise SystemExit(f"chip_smoke: kernels disagree with the plain version: {failures}")
    if "--kernels-only" in argv:
        print(f"(b) all kernels agree; --kernels-only: stopping after "
              f"{time.perf_counter() - t_start:.1f}s")
        return 0

    def elapsed(label):
        print(f"(t) {label}: {time.perf_counter() - t_start:.1f}s since the start")

    elapsed("(a) and (b)")
    # ---- (c) the main path: serve the full-width model ----
    cfg = full_config()
    state = params_from_jax(init_params(cfg, seed=0))
    # one copy on disk for the spawned serves (``_busy_child``, ``_fleet_child``)
    weights_dir = tempfile.TemporaryDirectory()
    weights = os.path.join(weights_dir.name, "lm-seed0.pt")
    torch.save(state, weights)
    serve_kw = dict(n_slots=8, block_len=16, prefill_chunk=32, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 1025, size=16)]
    max_new = 32
    warm = Scheduler(cfg, state, gather_impl="kernel", **serve_kw)
    warm.submit(prompts[0][:40], 2)
    warm.drain()  # cuBLAS handles, allocator pools, the kernel library
    del warm

    def all_launches():
        return {k: v for counts in (paged_flash.launch_counts,
                                    paged_flash.quant_launch_counts,
                                    paged_flash.route_launch_counts)
                for k, v in counts.items() if v}

    def on_tensor_cores(label, launches, sweep, split):
        """Fails the run unless the serve launched the sweep and the split
        (``sweep`` and ``split`` times) and every launch took the
        tensor-core route."""
        tc = [launches.get(paged_flash.route_key(k, paged_flash.TENSOR_CORES), 0)
              for k in (paged_flash.SWEEP, paged_flash.SPLIT)]
        if not (sweep > 0 and split > 0 and tc == [sweep, split]):
            raise SystemExit(f"chip_smoke: {label}: the sweep and split launches did not all "
                             f"take the tensor-core route: {launches}")

    def appended(label, launches, dt):
        """Fails the run unless a bf16-q serve on pools of the quantized
        dtype ``dt`` wrote every layer's new rows on the append route:
        standalone kernel 9 launched no time, and the append launches equal
        the sweep and split launches. Returns the append launches plus the
        standalone ones (kernel 9's launches)."""
        sweep, split, scatter = (paged_flash.variant(k, dt) for k in
                                 (paged_flash.SWEEP, paged_flash.SPLIT, paged_flash.QUANTIZE))
        attn = launches.get(sweep, 0) + launches.get(split, 0)
        app = sum(launches.get(paged_flash.append_key(k, dt), 0)
                  for k in (paged_flash.SWEEP, paged_flash.SPLIT))
        if launches.get(scatter, 0) or attn == 0 or app != attn:
            raise SystemExit(f"chip_smoke: {label}: the new rows did not all go through the "
                             f"append route (standalone kernel 9 {launches.get(scatter, 0)} "
                             f"launches, append {app}, sweep + split {attn}): {launches}")
        return app + launches.get(scatter, 0)

    def serve(label, reqs, *, stagger=0, warm=False, lagged=False, hook=None, model=None,
              **kw):
        """Serve ``reqs`` (``stagger`` steps between submissions) through
        the kernels by ``step()`` (``lagged``: by the lagged loop,
        ``lagged_drain``), the launch counts reset just before and read just
        after; every request must complete its budget inside the
        vocabulary and every block must come back, and on quantized pools
        every layer's new rows must take the append route (``appended``).
        With ``warm``, ``Scheduler.warmup(background=False)`` first, and
        the serve must capture no graph, hold no program the registry did
        not predict and count no cold request. Returns the scheduler, the
        streams in submit order, the metrics, the wall and the launches.
        ``hook(sched)`` runs before the first submit; ``model`` = (config,
        weights) serves another model than the MHA one."""
        sched = Scheduler(*(model or (cfg, state)), gather_impl="kernel", **{**serve_kw, **kw})
        if warm:
            sched.warmup(background=False)
        if hook is not None:
            hook(sched)
        captures = sched.engine.captures
        torch.cuda.synchronize()
        paged_flash.reset_launch_counts()
        t0 = time.perf_counter()
        rids, streams = [], {}
        for p in reqs:
            rids.append(sched.submit(p, max_new))
            for _ in range(stagger):
                for rid, tok in sched.step():
                    streams.setdefault(rid, []).append(tok)
        drained = lagged_drain(sched) if lagged else sched.drain()
        for rid, toks in drained.items():
            streams.setdefault(rid, []).extend(toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        m = sched.metrics()
        if sorted(streams) != sorted(rids) or any(len(streams[r]) != max_new for r in rids):
            raise SystemExit(f"chip_smoke: {label}: a request did not complete its budget")
        if any(not 0 <= t < cfg.vocab_size for r in rids for t in streams[r]):
            raise SystemExit(f"chip_smoke: {label}: a token outside the vocabulary")
        if kw.get("kv_dtype"):
            appended(label, launches, kv_pool_dtype(kw["kv_dtype"]))
        leaked = sched.engine.allocator.in_use - m["prefix_index_blocks"]
        if leaked or m["host_store_bytes"] or m["parked"]:
            raise SystemExit(f"chip_smoke: {label}: {leaked} blocks leaked, "
                             f"{m['host_store_bytes']} host bytes, {m['parked']} parked")
        serving_registry(sched.engine).assert_covers(sched.engine.compiled_program_names())
        if warm and (sched.engine.captures != captures or m["cold_requests"]):
            raise SystemExit(f"chip_smoke: {label}: after warmup the serve captured "
                             f"{sched.engine.captures - captures} graphs and counted "
                             f"{m['cold_requests']} cold requests")
        print(f"(c) {label}: {len(rids)} requests x {max_new} tokens on {card}: wall "
              f"{wall:.3f}s, {m['tokens_out'] / wall:.1f} tok/s, {m['steps']} ticks, TTFT "
              f"p50 {m['ttft_p50_s'] * 1e3:.1f} ms p95 {m['ttft_p95_s'] * 1e3:.1f} ms, "
              f"token gap p50 {m['token_lat_p50_s'] * 1e3:.2f} ms, tick p50 "
              f"{m['tick_p50_s'] * 1e3:.2f} ms, {m['pool_blocks']} pool blocks, "
              f"{m['graphs']} graphs ({m['compile_s']:.2f}s of capture), "
              f"{m['cold_requests']} cold requests; launches {launches}")
        return sched, [streams[r] for r in rids], m, wall, launches

    def per_tick(eng):
        """The kernels' launches in one decode tick with all 8 lanes armed."""
        paged_flash.reset_launch_counts()
        for slot in range(8):
            eng.admit(slot, 64, 1)
        eng.decode(np.full(8, 64), np.ones(8, bool))
        torch.cuda.synchronize()
        eng.release_all()
        return all_launches()

    sched, bf16_streams, m, wall, launches = serve("bf16 pools", prompts)
    on_tensor_cores("bf16 pools", launches, launches.get(paged_flash.SWEEP, 0),
                    launches.get(paged_flash.SPLIT, 0))
    mha_launches = dict(launches)
    print(f"(c) launches per decode tick: {per_tick(sched.engine)}")
    n_bf16 = sched.engine.allocator.n_blocks
    del sched
    torch.cuda.empty_cache()

    # final-prefill logits: kernel path against a plain-attention engine
    pair = [prompts[1], prompts[2]]
    rows = {impl: final_prefill_logits(torch, cfg, state, pair, max_new, impl)
            for impl in ("kernel", "dense")}
    logit_err = (rows["kernel"] - rows["dense"]).abs().max().item()
    greedy = {}
    for impl in ("kernel", "dense"):
        s = Scheduler(cfg, state, gather_impl=impl, **serve_kw)
        ids = [s.submit(p, max_new) for p in pair]
        out = s.drain()
        greedy[impl] = [out[i] for i in ids]
        del s
    match = np.mean([a == b for x, y in zip(greedy["kernel"], greedy["dense"])
                     for a, b in zip(x, y)])
    scale = rows["dense"].abs().max().item()
    print(f"(c) final-prefill logits, kernel vs plain attention, prompts "
          f"{[len(p) for p in pair]}: max_abs_err {logit_err:.4f} (|logits| <= "
          f"{scale:.2f}); greedy token match {match:.3f} over "
          f"{2 * max_new} tokens")
    if not np.isfinite(logit_err) or logit_err > 0.25:
        raise SystemExit("chip_smoke: kernel-path logits far from the plain path")

    # quantized pools of the bf16 pool's bytes: more blocks, same 16 requests
    quant_streams = {}
    for kv in QUANT:
        n_blocks = n_bf16 * pool_block_bytes(cfg, 16) // pool_block_bytes(cfg, 16, kv)
        sched, quant_streams[kv], _, _, lq = serve(f"{kv} pools", prompts,
                                                   kv_dtype=kv, n_blocks=n_blocks)
        tick = per_tick(sched.engine)
        dt = sched.engine.cache[0].key.dtype
        names = [paged_flash.variant(k, dt) for k in (paged_flash.SWEEP, paged_flash.SPLIT)]
        launches.update({k: lq.get(k, 0) for k in names})
        # kernel 9: its launches are the append route's (standalone: none)
        launches[paged_flash.variant(paged_flash.QUANTIZE, dt)] = appended(f"{kv} pools", lq, dt)
        print(f"(c) {kv}: {n_blocks} blocks in the bytes of {n_bf16} bf16 blocks "
              f"({n_blocks / n_bf16:.3f}x); greedy match with the bf16 serve "
              f"{match_rate(quant_streams[kv], bf16_streams):.3f}; launches per decode "
              f"tick {tick}")
        if (not all(lq.get(k, 0) > 0 for k in names)
                or tick.get(names[1], 0) != cfg.num_layers
                or tick.get(paged_flash.append_key(paged_flash.SPLIT, dt), 0) != cfg.num_layers
                or tick.get(paged_flash.variant(paged_flash.QUANTIZE, dt), 0)):
            raise SystemExit(f"chip_smoke: {kv}: a quantized kernel did not run on the "
                             f"main path, or kernel 9 ran apart from it: serve {lq}, tick {tick}")
        on_tensor_cores(f"{kv} pools", lq, lq[names[0]], lq[names[1]])
        del sched
        torch.cuda.empty_cache()

    # the serve's CUDA graphs against the eager path, warmup, a sampled serve
    graphs = graph_runs(torch, card, serve, cfg, state, prompts, serve_kw, n_blocks=n_blocks,
                        weights=weights)

    # prefix sharing: 16 requests on one 512-token prefix, submitted 4 steps apart
    prng = np.random.default_rng(1)
    shared = prng.integers(1, cfg.vocab_size, size=512).astype(np.int32)
    prefix_reqs = [np.concatenate([shared, prng.integers(1, cfg.vocab_size, size=int(n))
                                   .astype(np.int32)])
                   for n in prng.integers(16, 129, size=16)]
    on, on_streams, m_on, _, _ = serve("prefix on, fp8 pools", prefix_reqs, stagger=4,
                                       kv_dtype="fp8", prefix_cache=True)
    _, off_streams, m_off, _, _ = serve("prefix off, fp8 pools", prefix_reqs, stagger=4,
                                        kv_dtype="fp8")
    indexed = on.engine.allocator.in_use
    on.engine.release_all()
    print(f"(c) prefix: hit rate {m_on['prefix_hit_rate']:.3f} ({m_on['prefix_hits']} of "
          f"{m_on['prefix_lookups']}), admitted prefill tokens {m_on['admitted_prefill_tokens']}"
          f" vs {m_off['admitted_prefill_tokens']} off "
          f"({m_off['admitted_prefill_tokens'] / m_on['admitted_prefill_tokens']:.2f}x cut), "
          f"{m_on['prefix_cow_copies']} copy-on-write, {indexed} blocks in use = "
          f"{m_on['prefix_index_blocks']} indexed, {on.engine.allocator.in_use} after "
          f"release_all; greedy match with prefix off {match_rate(on_streams, off_streams):.3f}")
    if (m_on["prefix_hits"] < 1 or indexed != m_on["prefix_index_blocks"]
            or on.engine.allocator.in_use != 0):
        raise SystemExit("chip_smoke: the prefix serve shared nothing or leaked blocks")
    del on
    torch.cuda.empty_cache()

    # the pressure tier: 200 fp8 blocks for the 16 requests (about 590 at once)
    pressure_streams = {}
    for policy in ("swap", "recompute"):
        sched, st, mp, _, _ = serve(f"pressure, fp8 pools, 200 blocks, {policy}", prompts,
                                    **PRESSURE, swap_policy=policy)
        pressure_streams[policy] = st
        print(f"(c) pressure {policy}: {mp['preempts']} preempts, {mp['restores']} restores "
              f"(swap {mp['swap_outs']} out / {mp['swap_ins']} in, {mp['swap_bytes']} bytes, "
              f"wall mean {mp.get('swap_mean_s', 0.0) * 1e3:.2f} ms max "
              f"{mp.get('swap_max_s', 0.0) * 1e3:.2f} ms), greedy match with the ample fp8 serve "
              f"{match_rate(st, quant_streams['fp8']):.3f}")
        if not mp["preempts"] == mp["restores"] >= 1:
            raise SystemExit(f"chip_smoke: pressure {policy}: preempts {mp['preempts']}, "
                             f"restores {mp['restores']}")
        del sched
        torch.cuda.empty_cache()

    elapsed("the serves")
    # the request lifecycle and the dense decode path
    lifecycle_runs(
        torch, card, serve, cfg, state, prompts, serve_kw,
        pressure_kw={**PRESSURE, "swap_policy": "swap"}, pressure_streams=pressure_streams["swap"],
        busy=graphs["bf16"], recipe_argv=["--dense", "--requests", "8"])

    elapsed("the lifecycle")
    # the serving fleet and its gateway, in a process of its own; the
    # fleets' busy shares (``graph_runs``) beside one replica's
    torch.cuda.empty_cache()
    fleet = fleet_phase(card, cfg, prompts, serve_kw, FLEET_RECIPES, weights)
    print(fleet_line(card, fleet, {
        "one_step": graphs["bf16"]["graphs_busy"], "one_lagged": graphs["bf16"]["lagged_busy"],
        **graphs["fleet_busy"]}))
    weights_dir.cleanup()
    dt8 = kv_pool_dtype("fp8")
    fleet_launches = {**fleet["launches"], **fleet["fp8_launches"]}
    fleet_launches[paged_flash.variant(paged_flash.QUANTIZE, dt8)] = sum(
        fleet["fp8_launches"].get(k, 0) for k in (
            paged_flash.variant(paged_flash.QUANTIZE, dt8),
            *(paged_flash.append_key(k, dt8) for k in (paged_flash.SWEEP, paged_flash.SPLIT))))

    elapsed("the fleet")
    # ---- (c) the training path: LMTrainer on the full-width model ----
    torch.cuda.empty_cache()
    bsz, seq, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    tcfg = full_config(attention="flash")
    trainer = LMTrainer(
        tcfg, SyntheticTokens(steps * bsz, seq, tcfg.vocab_size),
        SyntheticTokens(bsz, seq, tcfg.vocab_size, seed=1),
        LMTrainerConfig(batch_size=bsz, lr=3e-4, warmup_steps=0, log_every=1,
                        grad_clip_norm=1.0), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.reset_launch_counts()
    trainer.train_epoch(0)
    torch.cuda.synchronize()
    train_launches = dict(flash_attention.launch_counts)
    flash_attention.reset_launch_counts()
    val = trainer.validate()
    val_launches = dict(flash_attention.launch_counts)
    losses = [r["loss"] for r in trainer.history]
    step_s = np.median([r["step_s"] for r in trainer.history[1:]])
    n_matmul = sum(m.weight.numel() for m in trainer.state.model.modules()
                   if isinstance(m, Dense))
    shape = (bsz, seq, tcfg.num_heads, tcfg.head_dim)
    fb_train = flash_bound(*(torch.empty(shape, dtype=bf16, device="meta") for _ in "qk"))
    attn_flops = tcfg.num_layers * (fb_train["fwd"]["flops"] + fb_train["bwd"]["flops"])
    step_flops = 6 * n_matmul * bsz * seq + attn_flops
    print(f"(c) trained {steps} steps of B={bsz} x L={seq} bf16 (fp32 parameters), flash "
          f"attention, on {card}: losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(r['grad_norm'], 3) for r in trainer.history]}")
    print(f"(c) step p50 {step_s * 1e3:.1f} ms (first step {trainer.history[0]['step_s']:.2f} s), "
          f"{bsz * seq / step_s:.0f} tokens/s; model {step_flops / 1e12:.2f} TFLOP/step "
          f"(6 x {n_matmul / 1e6:.1f} M matmul parameters x tokens + attention "
          f"{attn_flops / 1e12:.2f}) = {step_flops / step_s / 1e12:.1f} TFLOP/s, "
          f"{step_flops / step_s / PEAK_FLOPS['torch.bfloat16']:.3f} of 989; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    print(f"(c) validation: loss {val['loss']:.4f} over {val['tokens']:.0f} tokens; launches "
          f"during training {train_launches}, during validation {val_launches}")
    if len(losses) != steps or not all(np.isfinite(losses)) or not np.isfinite(val["loss"]):
        raise SystemExit(f"chip_smoke: a non-finite or missing training loss: {losses}")
    n_layers = tcfg.num_layers
    if train_launches != {FWD: n_layers * steps, BWD: n_layers * steps,
                          flash_attention.BWD_DKV: 0, flash_attention.BWD_DQ: 0}:
        raise SystemExit(f"chip_smoke: expected {n_layers} forward and {n_layers} backward "
                         f"flash launches per step, got {train_launches} in {steps} steps")
    if val_launches != {FWD: n_layers * len(trainer.val_loader), BWD: 0,
                        flash_attention.BWD_DKV: 0, flash_attention.BWD_DQ: 0}:
        raise SystemExit(f"chip_smoke: validation launches {val_launches}")
    del trainer
    torch.cuda.empty_cache()

    # the first step from the same weights on the same batch: flash vs dense
    pair_batch = {k: torch.from_numpy(v).cuda() for k, v in lm_collate(
        [SyntheticTokens(2, seq, tcfg.vocab_size, seed=2)[i] for i in range(2)]).items()}
    first = {}
    for attn in ("flash", "dense"):
        st = create_lm_state(full_config(attention=attn), lr_schedule=lambda step: 0.0,
                             params=state, device="cuda")
        _, m = make_lm_train_step(grad_clip_norm=1.0)(st, pair_batch)
        first[attn] = {k: float(v) for k, v in m.items()}
        del st, m
        torch.cuda.empty_cache()
    d_loss = abs(first["flash"]["loss"] - first["dense"]["loss"])
    d_norm = abs(first["flash"]["grad_norm"] / first["dense"]["grad_norm"] - 1)
    print(f"(c) first step B=2 x L={seq}, flash vs dense: loss {first['flash']['loss']:.5f} vs "
          f"{first['dense']['loss']:.5f} (|diff| {d_loss:.2e}, tol {TRAIN_LOSS_TOL:g}); grad "
          f"norm {first['flash']['grad_norm']:.5f} vs {first['dense']['grad_norm']:.5f} "
          f"(rel diff {d_norm:.2e}, tol {TRAIN_GRAD_NORM_RTOL:g})")
    if not (d_loss <= TRAIN_LOSS_TOL and d_norm <= TRAIN_GRAD_NORM_RTOL):
        raise SystemExit("chip_smoke: the flash training step disagrees with the dense one")

    elapsed("LM training")
    # ---- (c) the model branches: GQA + RoPE served and trained, MoE, dropout, blockwise ----
    with tempfile.TemporaryDirectory() as tmp:
        branches = branches_runs(torch, card, serve, per_tick, {
            "launches": mha_launches, "warm_bf16": graphs["bf16"], "warm_fp8": graphs["fp8"],
            "step_s": step_s}, prompts, serve_kw, tmp, BRANCH_RECIPE)
    torch.cuda.empty_cache()

    elapsed("the branches")
    # ---- (c) ResNet-50: the fused bf16 trainer, the first step, the recipe ----
    synthetic = resnet_runs(torch, card)
    torch.cuda.empty_cache()
    elapsed("ResNet-50")

    # ---- (c) the input pipeline: raw splits, the loader, ResNet-50 fed from records ----
    data = in_child(data_runs, card, synthetic=synthetic)
    elapsed("the data phase")

    # ---- (c) data-parallel ResNet-50: the ranks, sync-BN, fp16, the recipes ----
    with tempfile.TemporaryDirectory() as tmp:
        dp_runs(torch, card, tmp)
    torch.cuda.empty_cache()
    elapsed("data parallelism")

    # ---- (c) suspend, resume, fallback and rollback in both trainers ----
    with tempfile.TemporaryDirectory() as tmp:
        resume_runs(torch, card, tmp)
    torch.cuda.empty_cache()
    elapsed("resume")

    # ---- (c) the ring: ring_flash_attention and LMTrainer over 2 ranks ----
    with tempfile.TemporaryDirectory() as tmp:
        ring = ring_runs(torch, card, tmp)
    torch.cuda.empty_cache()
    elapsed("the ring")

    # ---- (c) ZeRO-3 FSDP and the GPipe pipeline over the ring's ranks, then
    # Megatron tensor parallelism, with vocab parallelism ----
    phases = in_child(parallel_and_tp, card)
    parallel, tp = phases["parallel"], phases["tp"]
    elapsed("FSDP, the pipeline and TP")

    # ---- (d) times at the decode shape ----
    import torch.nn.functional as F

    d = decode_bf16["q"].shape[-1]
    qg, kg, vg, mask = gathered(torch, decode_bf16)
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mask))
    plain_ms = time_ms(torch, lambda: paged_attention_reference(**decode_bf16))
    timed = {
        paged_flash.SWEEP: time_ms(torch, lambda: paged_flash.paged_flash_attention(
            **decode_bf16, split_s=1)),
        paged_flash.SPLIT: time_ms(torch, lambda: paged_flash.paged_flash_attention(
            **decode_bf16)),
    }
    tables32 = decode_bf16["block_tables"].to(torch.int32)
    qpos32 = decode_bf16["q_positions"].to(torch.int32)
    pools = (decode_bf16["q"], decode_bf16["k_pool"], decode_bf16["v_pool"],
             tables32, qpos32)
    bare = {
        paged_flash.SWEEP: time_ms(torch, lambda: paged_flash.launch_sweep(
            *pools, d ** -0.5)),
        paged_flash.SPLIT: time_ms(torch, lambda: paged_flash.launch_split(
            *pools, 8, d ** -0.5)),
    }
    # the split's kernel alone, by its device time
    split_device_ms = kernel_device_ms(torch, lambda: paged_flash.paged_flash_attention(
        **decode_bf16), {paged_flash.SPLIT: (is_split_kernel, 1)})[paged_flash.SPLIT]
    bd = bound(decode_bf16)
    for name in timed:
        device = (f"; the kernel {split_device_ms * 1e3:.1f} us device time"
                  if name == paged_flash.SPLIT else "")
        print(f"(d) {name} at decode B=8 H=12 D=64 W=128 bf16 on {card}: "
              f"{timed[name] * 1e3:.1f} us per call ({bare[name] * 1e3:.1f} us bare "
              f"launch{device}), plain {plain_ms * 1e3:.1f} us, SDPA on gathered K/V "
              f"{sdpa_ms * 1e3:.1f} us, bound {bd['bound_ms'] * 1e3:.2f} us "
              f"({bd['bound_by']}: {bd['bytes'] / 1e6:.2f} MB, {bd['flops'] / 1e6:.1f} MFLOP)")
    plains = {name: plain_ms for name in timed}
    bounds = {name: bd for name in timed}

    # the sweep where the serve runs it: the prefill chunk, B 4 x C 32, W 64
    pqg, pkg, pvg, pmask = gathered(torch, chunk)
    pre = {
        "prefill_ms": time_ms(torch, lambda: paged_flash.paged_flash_attention(
            **chunk, split_s=1)),
        "prefill_plain_ms": time_ms(torch, lambda: paged_attention_reference(**chunk)),
        "prefill_library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            pqg, pkg, pvg, attn_mask=pmask)),
    }
    pbd = bound(chunk)
    pre["prefill_bound_ms"] = pbd["bound_ms"]
    print(f"(d) {paged_flash.SWEEP} at prefill chunk B=4 C=32 H=12 D=64 W=64 bf16 on {card}: "
          f"{pre['prefill_ms'] * 1e3:.1f} us per call, plain {pre['prefill_plain_ms'] * 1e3:.1f} "
          f"us, SDPA on gathered K/V {pre['prefill_library_ms'] * 1e3:.1f} us, bound "
          f"{pbd['bound_ms'] * 1e3:.2f} us ({pbd['bound_by']}: {pbd['bytes'] / 1e6:.2f} MB, "
          f"{pbd['flops'] / 1e6:.1f} MFLOP)")
    del pqg, pkg, pvg, pmask

    # kernels 7 and 8 at the GQA + RoPE model's G = 3 shapes, bf16 and fp8
    # pools: the sweep and the split at decode (R = 3), the sweep at the
    # prefill chunk (R = 96); the pool read is a third of MHA's bytes
    g3_times = {}
    for (shape, kv), inp in g3.items():
        bq = bound(inp)
        t_plain = time_ms(torch, lambda: paged_attention_reference(**inp))
        tag = "g3_" + shape.replace(" ", "_")
        calls = ((paged_flash.SWEEP, 1), (paged_flash.SPLIT, None))
        for name, split_s in calls if shape == "decode" else calls[:1]:
            key = name if kv == "bf16" else paged_flash.variant(name, inp["k_pool"].dtype)
            t = time_ms(torch, lambda: paged_flash.paged_flash_attention(**inp, split_s=split_s))
            g3_times.setdefault(key, {}).update({
                f"{tag}_ms": t, f"{tag}_plain_ms": t_plain, f"{tag}_bound_ms": bq["bound_ms"],
                f"{tag}_bound_by": bq["bound_by"]})
            print(f"(d) {key} at G=3 {shape} (H 12 over H_kv 4, D 64, R = "
                  f"{3 * inp['q'].shape[1]}), {kv} pools, bf16 q, on {card}: {t * 1e3:.1f} us "
                  f"per call, plain {t_plain * 1e3:.1f} us, bound {bq['bound_ms'] * 1e3:.2f} us "
                  f"({bq['bound_by']}: {bq['bytes'] / 1e6:.2f} MB, {bq['flops'] / 1e6:.1f} MFLOP)")

    # the quantized pools with bf16 q (the tensor-core kernels) at the decode
    # shape, the sweep also at the prefill chunk, where the serve runs it
    # (its 276 launches a serve are all prefill calls), each also by its
    # kernel's device time; the scatter at the chunk and decode shapes. No
    # single PyTorch call reads int8/fp8 K/V with per-row scales, so these
    # have no library time; the spelling (gather, dequantize, SDPA) stands
    # beside them
    quant_extra = {}
    kernel_names = {paged_flash.SWEEP: "paged_sweep_tc_kernel",
                    paged_flash.SPLIT: "paged_split_tc_kernel"}
    matches = {paged_flash.SWEEP: is_sweep_kernel, paged_flash.SPLIT: is_split_kernel}
    for kv, inp in decode_q.items():
        bq = bound(inp)
        q_plain = time_ms(torch, lambda: paged_attention_reference(**inp))
        q_spell = time_ms(torch, quant_spelling(torch, inp))
        for name, split_s in ((paged_flash.SWEEP, 1), (paged_flash.SPLIT, None)):
            key = paged_flash.variant(name, inp["k_pool"].dtype)
            call = lambda: paged_flash.paged_flash_attention(**inp, split_s=split_s)  # noqa: E731
            timed[key] = time_ms(torch, call)
            dev_ms = kernel_device_ms(torch, call, {key: (matches[name], 1)})[key]
            plains[key], bounds[key] = q_plain, bq
            quant_extra[key] = {"kernel": f"{kernel_names[name]}[{kv}]", "device_ms": dev_ms,
                                "spelling_ms": q_spell}
            print(f"(d) {key} at decode B=8 H=12 D=64 W=128, bf16 q, on {card}: "
                  f"{timed[key] * 1e3:.1f} us per call ({kernel_names[name]} "
                  f"{dev_ms * 1e3:.1f} us device time), plain {q_plain * 1e3:.1f} us, "
                  f"spelling (gather, dequantize, SDPA) {q_spell * 1e3:.1f} us, bound "
                  f"{bq['bound_ms'] * 1e3:.2f} us ({bq['bound_by']}: {bq['bytes'] / 1e6:.2f} "
                  f"MB, {bq['bound_ms'] / bd['bound_ms']:.2f}x the bf16 bound)")
        cinp = chunk_q[kv]
        key = paged_flash.variant(paged_flash.SWEEP, cinp["k_pool"].dtype)
        call = lambda: paged_flash.paged_flash_attention(**cinp, split_s=1)  # noqa: E731
        cbd = bound(cinp)
        extra = {
            "prefill_ms": time_ms(torch, call),
            "prefill_device_ms": kernel_device_ms(
                torch, call, {key: (is_sweep_kernel, 1)})[key],
            "prefill_plain_ms": time_ms(torch, lambda: paged_attention_reference(**cinp)),
            "prefill_spelling_ms": time_ms(torch, quant_spelling(torch, cinp)),
            "prefill_bound_ms": cbd["bound_ms"],
        }
        quant_extra[key].update(extra)
        print(f"(d) {key} at prefill chunk B=4 C=32 H=12 D=64 W=64, bf16 q, on {card}: "
              f"{extra['prefill_ms'] * 1e3:.1f} us per call (paged_sweep_tc_kernel "
              f"{extra['prefill_device_ms'] * 1e3:.1f} us device time), plain "
              f"{extra['prefill_plain_ms'] * 1e3:.1f} us, spelling "
              f"{extra['prefill_spelling_ms'] * 1e3:.1f} us, bound {cbd['bound_ms'] * 1e3:.2f} us "
              f"({cbd['bound_by']}: {cbd['bytes'] / 1e6:.2f} MB, {cbd['flops'] / 1e6:.1f} MFLOP)")
    for kv in QUANT:
        for label, (b_, l_) in (("chunk 8 jobs x 32 rows", (8, 32)), ("decode 8 rows", (8, 1))):
            args = scatter_inputs(torch, kv, bf16, b=b_, l=l_, seed=8)
            sb = scatter_bound(args)
            key = paged_flash.variant(paged_flash.QUANTIZE, args[4].dtype)
            t_kernel = time_ms(torch, lambda: paged_flash.paged_quantize_scatter(*args))
            t_dev = kernel_device_ms(torch, lambda: paged_flash.paged_quantize_scatter(*args),
                                     {key: (is_quantize_kernel, 1)})[key]
            t_plain = time_ms(torch, lambda: paged_flash.paged_quantize_scatter_reference(
                *args))
            print(f"(d) {key} at {label}, H=12 D=64 bf16, on {card}: {t_kernel * 1e3:.1f} us "
                  f"per call ({t_dev * 1e3:.2f} us device time), plain {t_plain * 1e3:.1f} us, "
                  f"bound {sb['bound_ms'] * 1e3:.3f} us ({sb['bound_by']}: "
                  f"{sb['bytes'] / 1e3:.1f} KB)")
            extra = quant_extra.setdefault(key, {"kernel": f"quantize_scatter_kernel[{kv}]"})
            if l_ == 1:
                timed[key], plains[key], bounds[key] = t_kernel, t_plain, sb
                extra["device_ms"] = t_dev
            else:
                extra.update(chunk_ms=t_kernel, chunk_device_ms=t_dev)
    # kernel 9 on the append route, one layer as the serve runs it: the
    # split at decode, the sweep at the prefill chunk, each writing the
    # layer's new rows itself; beside the two-launch route (kernel 9, then
    # the same tensor-core kernel) and the kernel alone (no rows written),
    # by CUDA events and by device time
    for kv in QUANT:
        for shape, inp, split_s, name, match in (
                ("decode", decode_q[kv], None, "split", is_split_kernel),
                ("prefill chunk", chunk_q[kv], 1, "sweep", is_sweep_kernel)):
            k, v = new_rows(torch, inp, seed=16)
            pools = (inp["k_pool"], inp["v_pool"], inp["k_scale"], inp["v_scale"])
            where = (inp["block_tables"], inp["q_positions"])
            # the destinations once, outside the timed call, as the model's
            # PagedIndex computes them once a forward for every layer
            blk, off = paged_flash.append_destinations(*where, inp["k_pool"].shape[1])

            def append_call():
                return paged_flash.paged_quantize_scatter_attention(inp["q"], k, v, *pools,
                                                                    *where, split_s=split_s)

            def two_launches():
                paged_flash.paged_quantize_scatter(k, v, blk, off, *pools)
                return paged_flash.paged_flash_attention(**inp, split_s=split_s)

            def alone():
                return paged_flash.paged_flash_attention(**inp, split_s=split_s)

            t = {"alone": time_ms(torch, alone), "append": time_ms(torch, append_call),
                 "two": time_ms(torch, two_launches)}
            dev = {"alone": kernel_device_ms(torch, alone, {"k": (match, 1)})["k"],
                   "append": kernel_device_ms(torch, append_call, {"k": (match, 1)})["k"]}
            two = kernel_device_ms(torch, two_launches,
                                   {"k": (match, 1), "scatter": (is_quantize_kernel, 1)})
            dev["two"] = two["k"] + two["scatter"]
            key = paged_flash.variant(paged_flash.QUANTIZE, inp["k_pool"].dtype)
            tag = f"{name} {shape}".replace(" ", "_")
            quant_extra[key].update({
                f"append_{tag}_ms": t["append"], f"append_{tag}_device_ms": dev["append"],
                f"scatter_then_{tag}_ms": t["two"], f"scatter_then_{tag}_device_ms": dev["two"],
                f"{tag}_alone_ms": t["alone"], f"{tag}_alone_device_ms": dev["alone"]})
            print(f"(d) {key} on the append route, the {name} at {shape}, {kv} pools, bf16 q, "
                  f"on {card}: append {t['append'] * 1e3:.1f} us per call "
                  f"({dev['append'] * 1e3:.1f} us device time); kernel 9 then the {name} "
                  f"{t['two'] * 1e3:.1f} us ({two['scatter'] * 1e3:.2f} + {two['k'] * 1e3:.1f} us "
                  f"device time); the {name} alone {t['alone'] * 1e3:.1f} us "
                  f"({dev['alone'] * 1e3:.1f} us device time)")

    # flash kernels at the training shape; the backward's time is the
    # wrapper's (Delta, the kernel, the dQ cast), as the training step runs it
    q, k, v, do = flash_inputs(torch, bf16, b=bsz, l=seq, seed=7)
    sc = q.shape[-1] ** -0.5
    o, lse = flash_attention.launch_forward(q, k, v, True, sc, 0)
    fb = flash_bound(q, k)
    flash_ms = {
        FWD: time_ms(torch, lambda: flash_attention.launch_forward(q, k, v, True, sc, 0),
                     iters=20),
        BWD: time_ms(torch, lambda: flash_attention.launch_backward(
            q, k, v, o, lse, do, True, sc, 0), iters=20),
    }
    flash_plain_ms = {
        FWD: time_ms(torch, lambda: flash_attention.flash_forward_reference(
            q, k, v, causal=True, scale=sc), iters=3, warmup=1),
        BWD: time_ms(torch, lambda: flash_attention.flash_backward_reference(
            q, k, v, o, lse, do, causal=True, scale=sc), iters=3, warmup=1),
    }
    qg, kg, vg = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dog = do.transpose(1, 2).contiguous()
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    flash_lib_ms = {
        FWD: time_ms(torch, lambda: F.scaled_dot_product_attention(qg, kg, vg, is_causal=True),
                     iters=20),
        BWD: time_ms(torch, lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dog,
                                                         retain_graph=True), iters=20),
    }
    sdpa_fwdbwd = time_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True), (qg, kg, vg), dog),
        iters=20)
    # the kernels alone, by their device time (the backward call also runs
    # Delta, the row statistics' copy and the dQ cast as torch ops)
    flash_kernel_ms = {
        FWD: kernel_device_ms(torch, lambda: flash_attention.launch_forward(
            q, k, v, True, sc, 0), {FWD: (lambda key: "flash_fwd" in key, 1)})[FWD],
        BWD: kernel_device_ms(torch, lambda: flash_attention.launch_backward(
            q, k, v, o, lse, do, True, sc, 0), {BWD: (lambda key: "flash_bwd" in key, 1)})[BWD],
    }
    for name, part in ((FWD, "fwd"), (BWD, "bwd")):
        print(f"(d) {name} at B, L, H, D = {tuple(q.shape)} causal bf16 on {card}: "
              f"{flash_ms[name] * 1e3:.1f} us per call "
              f"({fb[part]['flops'] / flash_ms[name] / 1e9:.1f} TFLOP/s; the kernel "
              f"{flash_kernel_ms[name] * 1e3:.1f} us device time), plain "
              f"{flash_plain_ms[name] * 1e3:.1f} us, SDPA {flash_lib_ms[name] * 1e3:.1f} us, "
              f"bound {fb[part]['bound_ms'] * 1e3:.1f} us ({fb[part]['bound_by']}: "
              f"{fb[part]['bytes'] / 1e6:.1f} MB, {fb[part]['flops'] / 1e9:.1f} GFLOP)")
    print(f"(d) SDPA forward + backward {sdpa_fwdbwd * 1e3:.1f} us; the kernels' "
          f"{(flash_ms[FWD] + flash_ms[BWD]) * 1e3:.1f} us")

    # kernel 6 at the training shape: the wrapper (Delta, both kernels) by
    # CUDA events, each kernel by its device time in a profiler trace
    DKV, DQ = flash_attention.BWD_DKV, flash_attention.BWD_DQ
    split_call = lambda: flash_attention.launch_backward_split(  # noqa: E731
        q, k, v, o, lse, do, True, sc, 0)
    split_pair_ms = time_ms(torch, split_call, iters=20)
    split_ms = kernel_device_ms(torch, split_call, {
        DKV: (is_dkv_kernel, 1), DQ: (is_dq_kernel, 1)})
    for name, part in ((DKV, "bwd_dkv"), (DQ, "bwd_dq")):
        fb[name] = fb[part]
        print(f"(d) {name} at B, L, H, D = {tuple(q.shape)} causal bf16 on {card}: "
              f"{split_ms[name] * 1e3:.1f} us device time per launch "
              f"({fb[part]['flops'] / split_ms[name] / 1e9:.1f} TFLOP/s), bound "
              f"{fb[part]['bound_ms'] * 1e3:.1f} us ({fb[part]['bound_by']}: "
              f"{fb[part]['bytes'] / 1e6:.1f} MB, {fb[part]['flops'] / 1e9:.1f} GFLOP)")
    print(f"(d) split backward (Delta + {DKV} + {DQ}) {split_pair_ms * 1e3:.1f} us per call "
          f"({fb['bwd_split']['flops'] / split_pair_ms / 1e9:.1f} TFLOP/s), bound "
          f"{fb['bwd_split']['bound_ms'] * 1e3:.1f} us ({fb['bwd_split']['bound_by']}: "
          f"{fb['bwd_split']['flops'] / 1e9:.1f} GFLOP); fused {flash_ms[BWD] * 1e3:.1f} us, "
          f"plain {flash_plain_ms[BWD] * 1e3:.1f} us, SDPA backward "
          f"{flash_lib_ms[BWD] * 1e3:.1f} us")

    tail_times = time_tail_kernels(torch, card)
    elapsed("(d)")

    # ---- (e) the kernels line; (f) the result ----
    replaces = {
        paged_flash.SWEEP: "pytorch_distributed_tpu/ops/paged_flash.py:375",
        paged_flash.SPLIT: "pytorch_distributed_tpu/ops/paged_flash.py:430",
        paged_flash.QUANTIZE: "pytorch_distributed_tpu/ops/paged_flash.py:563",
    }
    # every path's launches: the MHA serves', the model-branches phase's
    # GQA serves (``gqa_launches`` apart) and the TP serve's on every rank
    # (``tp_serve_launches`` apart)
    kernels = [{
        "name": name, "route": "cuda",
        "source": "pytorch_distributed_tpu_torch/csrc/paged_attention.cu",
        "replaces": replaces[name.split("[")[0]],
        "launches": (launches[name] + branches["launches"].get(name, 0)
                     + tp["serve_launches"].get(name, 0)),
        "gqa_launches": branches["launches"].get(name, 0),
        "tp_serve_launches": tp["serve_launches"].get(name, 0),
        **({"tp": tp["paged_kernels"][name]} if name in tp["paged_kernels"] else {}),
        "fleet_launches": fleet_launches.get(name, 0), "max_abs_err": errs[name],
        "ms": timed[name], "plain_ms": plains[name],
        "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
        "library_ms": sdpa_ms if "[" not in name else None,
        **(pre if name == paged_flash.SWEEP else {}),
        **({"kernel": "paged_split_tc_kernel", "device_ms": split_device_ms}
           if name == paged_flash.SPLIT else {}),
        **({"kernel": "paged_sweep_tc_kernel"} if name == paged_flash.SWEEP else {}),
        **quant_extra.get(name, {}),
        **({"append_out_max_abs_err": append_errs[name]} if name in append_errs else {}),
        **g3_times.get(name, {}),
    } for name in timed]
    flash_replaces = {FWD: "pytorch_distributed_tpu/ops/flash_attention.py:138",
                      BWD: "pytorch_distributed_tpu/ops/flash_attention.py:375"}
    kernels += [{
        "name": name, "route": "cuda",
        "source": "pytorch_distributed_tpu_torch/csrc/flash_attention.cu",
        "replaces": flash_replaces[name],
        "launches": (train_launches[name] + branches["flash"][name]
                     + parallel["flash_launches"][name] + tp["flash_launches"][name]),
        "gqa_launches": branches["flash"][name],
        "parallel_launches": parallel["flash_launches"][name],
        "tp_launches": tp["flash_launches"][name], "tp": tp["kernels"][name],
        "max_abs_err": flash_errs[name], "ms": flash_ms[name],
        "plain_ms": flash_plain_ms[name], "bound_ms": fb[part]["bound_ms"],
        "bound_by": fb[part]["bound_by"], "library_ms": flash_lib_ms[name],
    } for name, part in ((FWD, "fwd"), (BWD, "bwd"))]
    # kernel 6: launches on the ring's split-backward path; its plain
    # version and SDPA's backward compute both kernels' work in one call
    kernels += [{
        "name": name, "route": "cuda",
        "source": "pytorch_distributed_tpu_torch/csrc/flash_attention.cu",
        "replaces": replaces_at, "launches": ring["split_launches"][name],
        "max_abs_err": split_errs[name], "ms": split_ms[name],
        "plain_ms": flash_plain_ms[BWD], "bound_ms": fb[name]["bound_ms"],
        "bound_by": fb[name]["bound_by"], "library_ms": flash_lib_ms[BWD],
    } for name, replaces_at in ((DKV, "pytorch_distributed_tpu/ops/flash_attention.py:451"),
                                (DQ, "pytorch_distributed_tpu/ops/flash_attention.py:434"))]
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

    tail_replaces = {bt.MOMENTS: "pytorch_distributed_tpu/ops/bottleneck_tail.py:69",
                     bt.BWD_REDUCE: "pytorch_distributed_tpu/ops/bottleneck_tail.py:114",
                     bt.BWD_DZ: "pytorch_distributed_tpu/ops/bottleneck_tail.py:160"}
    kernels += [{
        "name": name, "route": "cuda",
        "source": "pytorch_distributed_tpu_torch/csrc/bottleneck_tail.cu",
        "replaces": tail_replaces[name],
        "launches": data["tail_launches"][name] + parallel["tail_launches"][name],
        "parallel_launches": parallel["tail_launches"][name],
        "max_abs_err": tail_errs[name], **tail_times[name],
    } for name in (bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ)]
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
