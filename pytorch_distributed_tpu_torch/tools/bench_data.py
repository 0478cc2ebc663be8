"""The input pipeline's rates on this host (the port of the JAX package's
``scripts/bench_data.py``), one JSON line a stage:

  1. ``record_read``: the TPRC reader, records/s and MB/s, with and
     without the per-read CRC;
  2. ``jpeg_rrc``: the JPEG split (PIL decode, RandomResizedCrop, flip,
     normalize) through the loader, img/s;
  3. ``raw_rrc``, ``raw_crop_native``, ``raw_crop_per_sample``: the raw
     uint8 split through the loader, RandomResizedCrop (PIL) or the
     random crop, the latter by the native whole-batch crop and by the
     per-sample path;
  4. ``end_to_end``: loader and the copy of each batch to the card
     (``--device``, CUDA by default), img/s.

Each loader stage times whole fresh epochs (``data.loader.
measure_throughput``) at batch 128 with ``--workers`` threads (default:
the host's cores) and ``--prefetch``; every line carries the host's core
count, since the loader is bound by the host. The splits are packed in a
temporary directory from seeded images (``--n`` of them, 256 px); the
JPEG and ``rrc`` stages need PIL and are skipped without it.

    python -m pytorch_distributed_tpu_torch.tools.bench_data [--n 2048] [--skip-jpeg]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

BATCH = 128


def raw_images(n: int, size: int = 256, seed: int = 0) -> Iterator[Tuple[np.ndarray, int]]:
    """``n`` seeded uint8 ``size`` x ``size`` images and labels (0-999):
    8-pixel blocks of noise, which compress like a photo, not like white
    noise. At the stored size they pack without PIL."""
    rng = np.random.default_rng(seed)
    ones = np.ones((8, 8, 1), np.uint8)
    for i in range(n):
        yield np.kron(rng.integers(0, 255, (size // 8, size // 8, 3), np.uint8), ones), i % 1000


def jpeg_images(n: int, size: int = 256, seed: int = 0) -> Iterator[Tuple[bytes, int]]:
    """``raw_images`` encoded as JPEG (quality 90); needs PIL."""
    from PIL import Image

    for img, label in raw_images(n, size, seed):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        yield buf.getvalue(), label


def have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def cores() -> int:
    return os.cpu_count() or 1


def reader_rate(path: str, n: int) -> List[dict]:
    """The native reader's batched reads of ``n`` records in a seeded
    order, 256 a call, with and without CRC."""
    from pytorch_distributed_tpu_torch.data.packed_record import PackedRecordReader

    out = []
    with PackedRecordReader(path) as r:
        idx = np.random.default_rng(1).permutation(len(r))[:n]
        for verify in (True, False):
            t0 = time.perf_counter()
            total = 0
            for lo in range(0, len(idx), 256):
                total += sum(len(rec) for rec in r.read_batch(
                    [int(i) for i in idx[lo:lo + 256]], verify_crc=verify))
            dt = time.perf_counter() - t0
            out.append({"stage": "record_read", "verify_crc": verify,
                        "native": r._native is not None, "rec_s": len(idx) / dt,
                        "mb_s": total / 2 ** 20 / dt, "cores": cores()})
    return out


def loader_rate(name: str, dataset, workers: int, prefetch: int = 2,
                batch: int = BATCH) -> dict:
    """img/s of whole fresh epochs of ``dataset`` through the loader."""
    from pytorch_distributed_tpu_torch.data.loader import DataLoader, measure_throughput

    loader = DataLoader(dataset, batch, num_workers=workers, prefetch=prefetch)
    img_s = measure_throughput(loader)
    return {"stage": name, "img_s": img_s, "workers": workers, "prefetch": prefetch,
            "batch": batch, "cores": cores(), "img_s_per_core": img_s / cores()}


def end_to_end(dataset, workers: int, device, prefetch: int = 2, batch: int = BATCH) -> dict:
    """img/s of a loader epoch whose every batch is pinned and copied to
    ``device`` (waited for at the end), and one batch's copy alone."""
    from pytorch_distributed_tpu_torch.data.loader import DataLoader, to_device

    device = torch.device(device)
    cuda = device.type == "cuda"
    loader = DataLoader(dataset, batch, num_workers=workers, prefetch=prefetch,
                        pin_memory=cuda)
    first = loader.collate(range(batch))
    to_device(first, device)
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    seen = 0
    for b in loader.iter_batches(0):
        on_card = to_device(b, device)
        seen += len(b["label"])
    if cuda:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    del on_card
    n_bytes = sum(v.numel() * v.element_size() for v in first.values())
    ms = copy_ms(first, device)
    return {"stage": "end_to_end", "device": str(device), "img_s": seen / dt, "workers": workers,
            "prefetch": prefetch, "batch": batch, "cores": cores(),
            "image_dtype": str(first["image"].dtype), "batch_mb": n_bytes / 1e6,
            "copy_ms": ms, "copy_gb_s": n_bytes / ms / 1e6}


def copy_ms(batch, device, repeats: int = 5) -> float:
    """The median ms of copying ``batch`` (host tensors) to ``device``,
    waited for."""
    from pytorch_distributed_tpu_torch.data.loader import to_device

    device = torch.device(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        to_device(batch, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def main(argv: Optional[List[str]] = None) -> List[dict]:
    from pytorch_distributed_tpu_torch._device import resolve_device
    from pytorch_distributed_tpu_torch.data import (
        ImageNet,
        RawImageNet,
        write_imagenet_raw_split,
    )
    from pytorch_distributed_tpu_torch.data import transforms as T
    from pytorch_distributed_tpu_torch.data.imagenet import write_imagenet_split

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=2048, help="images in each split")
    p.add_argument("--workers", type=int, default=cores())
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--skip-jpeg", action="store_true")
    p.add_argument("--device", default=None,
                   help="the end-to-end stage's device: cuda (the default, which needs a "
                        "card) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pil = have_pil()
    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_imagenet_raw_split(os.path.join(tmp, "train.rawtprc"), raw_images(args.n))
        pack = {"stage": "pack", "n": args.n, "raw_pack_s": time.perf_counter() - t0,
                "raw_mb": os.path.getsize(os.path.join(tmp, "train.rawtprc")) / 2 ** 20}
        jpeg = pil and not args.skip_jpeg
        if jpeg:
            t0 = time.perf_counter()
            write_imagenet_split(os.path.join(tmp, "train.tprc"), jpeg_images(args.n))
            pack["jpeg_pack_s"] = time.perf_counter() - t0
        emit(pack)
        for line in reader_rate(os.path.join(tmp, "train.rawtprc"), args.n):
            emit(line)
        w, pf = args.workers, args.prefetch
        if jpeg:
            emit(loader_rate("jpeg_rrc", ImageNet("train", T.train_transform(), tmp), w, pf))
        if pil:
            emit(loader_rate("raw_rrc", RawImageNet("train", tmp, aug="rrc"), w, pf))
        emit(loader_rate("raw_crop_native", RawImageNet("train", tmp, aug="crop"), w, pf))
        emit(loader_rate("raw_crop_per_sample",
                         RawImageNet("train", tmp, aug="crop", use_native=False), w, pf))
        emit(end_to_end(RawImageNet("train", tmp, aug="crop"), w, device, pf))
    return lines


if __name__ == "__main__":
    main()
