"""Where a training step's time goes on the card.

``--model lm`` (the default) trains the ``chip_smoke.py`` LM configuration
(the full-width LM, random weights from seed 0, synthetic tokens, batch
8 x 2048, bf16 compute on fp32 parameters, flash attention, clip 1.0);
``--model resnet50`` trains ResNet-50 (bf16 compute on fp32 parameters,
synthetic 224^2 images, batch 128, SGD(0.1, 0.9, 1e-4)), with ``--fused``
through the fused bottleneck blocks and their tail kernels. Two warm-up
steps, then three profiled under ``torch.profiler``; it prints:

- the unprofiled step time (p50 of five steps, host clock after a sync);
- the device's busy share over the profiled steps;
- device time per step by kind of kernel: the port's own kernels (flash
  forward and backward; the tail's moments, tail_bwd_reduce and
  tail_bwd_dz, each with its share of the step's device time),
  convolutions, matrix products (the fused CE's TF32 ones apart), the
  optimizer, copies and casts, elementwise work, reductions, and the rest;
- the top operators by device time.

    python -m pytorch_distributed_tpu_torch.tools.profile_train [--attention dense --batch 2]
    python -m pytorch_distributed_tpu_torch.tools.profile_train --model resnet50 [--fused]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_distributed_tpu_torch.data import (
    SyntheticImageClassification,
    SyntheticTokens,
    image_collate,
    to_device,
)
from pytorch_distributed_tpu_torch.models.resnet import resnet50
from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt
from pytorch_distributed_tpu_torch.recipes.serve_lm import full_config
from pytorch_distributed_tpu_torch.tools.profile_serve import busy_share
from pytorch_distributed_tpu_torch.train import (
    create_lm_state,
    create_resnet_state,
    lm_collate,
    make_lm_train_step,
    make_train_step,
)

GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")
CONV_MARKS = ("conv", "fprop", "dgrad", "wgrad", "cudnn")
TAIL_KINDS = ("tail moments", "tail_bwd_reduce", "tail_bwd_dz")
_TAIL_KIND = dict(zip((bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ), TAIL_KINDS))


def kind_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "flash_fwd" in name:  # flash_fwd_wgmma_kernel (bf16), flash_fwd_kernel (fp32)
        return "flash forward"
    if "flash_bwd" in name:  # the wgmma backward, the fp32 and dQ kernels
        return "flash backward"
    tail = bt.kernel_of(kernel_name)  # the three tail kernels, their merges
    if tail is not None:
        return _TAIL_KIND[tail]
    if "copy" in name:
        return "copies and casts"
    if any(m in name for m in CONV_MARKS):
        return "convolutions"
    if any(m in name for m in GEMM_MARKS):
        # the fused CE's products run in TF32 on bf16-valued operands
        return "matrix products, tf32" if "tf32" in name else "matrix products"
    if "multi_tensor_apply" in name:
        return "optimizer"
    if "elementwise" in name:
        return "elementwise"
    if "reduce" in name:
        return "reductions"
    return "other"


def _lm(args):
    cfg = full_config(attention=args.attention)
    state = create_lm_state(cfg, lr_schedule=lambda step: 3e-4, weight_decay=0.1,
                            device="cuda")
    step = make_lm_train_step(grad_clip_norm=1.0)
    data = SyntheticTokens(10 * args.batch, args.seq, cfg.vocab_size)
    batches = [to_device({k: torch.from_numpy(v) for k, v in lm_collate(
        [data[i * args.batch + j] for j in range(args.batch)]).items()}, "cuda")
        for i in range(10)]
    return state, step, batches, args.batch * args.seq, "tokens_per_s"


def _resnet(args):
    model = resnet50(dtype=torch.bfloat16, fused_bottleneck=args.fused)
    state = create_resnet_state(model, lr_schedule=lambda step: 0.1, device="cuda")
    data = SyntheticImageClassification(3 * args.batch, 224, 1000)
    batches = [to_device({k: torch.from_numpy(v) for k, v in image_collate(
        [data[i * args.batch + j] for j in range(args.batch)]).items()}, "cuda")
        for i in range(3)]
    return state, make_train_step(), batches, args.batch, "images_per_s"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("lm", "resnet50"), default="lm")
    p.add_argument("--fused", action="store_true",
                   help="resnet50: the fused bottleneck blocks (the tail kernels)")
    p.add_argument("--attention", choices=("flash", "dense"), default="flash")
    p.add_argument("--batch", type=int, default=None, help="default 8 (lm) or 128 (resnet50)")
    p.add_argument("--seq", type=int, default=2048)
    args = p.parse_args(argv)
    args.batch = args.batch or (128 if args.model == "resnet50" else 8)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    state, step, batches, items, rate_name = (_resnet if args.model == "resnet50" else _lm)(args)

    def run(i):
        _, m = step(state, batches[i % len(batches)])
        return m

    for i in range(2):
        float(run(i)["loss"])
    times = []
    for i in range(5):
        t = time.perf_counter()
        float(run(i)["loss"])
        times.append(time.perf_counter() - t)
    n_prof = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_prof):
            run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kind_of(e.name)
            by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end - e.time_range.start)
    device_ms = {k: v / 1e3 / n_prof for k, v in sorted(by_kind.items())}
    total = sum(device_ms.values())
    summary = {
        "card": card, "model": args.model, "batch": args.batch,
        "step_p50_ms": 1e3 * float(np.median(times)),
        rate_name: items / float(np.median(times)),
        "profiled_step_ms": 1e3 * wall / n_prof,
        "device_busy_share": busy_share(prof, wall * 1e6),
        "device_ms_per_step": device_ms,
        "device_ms_per_step_total": total,
    }
    if args.model == "resnet50":
        summary["fused"] = args.fused
        summary["tail_share_of_device_time"] = {
            k: device_ms.get(k, 0.0) / total for k in TAIL_KINDS}
    else:
        summary.update(attention=args.attention, seq=args.seq)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=60))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
