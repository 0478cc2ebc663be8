"""Pack an ImageFolder-layout dataset into TPRC splits, the port's own
writer (``scripts/pack_imagenet.py`` of the JAX package, the same flags;
the files are byte-identical to that script's).

  jpeg mode (default)  <split>.tprc      label + the image file's bytes
                                         (decoded when read)
  raw mode             <split>.rawtprc   decoded once to uint8, the shorter
                                         side resized to --image-size and
                                         center-cropped square

Input: ``<src>/<class_name>/<image>.{jpg,jpeg,png,bmp,webp}``, labels by
sorted class directory name (torchvision's ImageFolder). Raw mode needs
PIL to decode; jpeg mode does not. After packing the whole file's CRCs
are checked (``PackedRecordReader.verify_all``).

    python -m pytorch_distributed_tpu_torch.tools.pack_imagenet SRC OUT --split train
    python -m pytorch_distributed_tpu_torch.tools.pack_imagenet SRC OUT --split val --raw
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def iter_images(src: str):
    """``(path, label)`` of every image, class by class in sorted order."""
    classes = sorted(d for d in os.listdir(src) if os.path.isdir(os.path.join(src, d)))
    if not classes:
        raise SystemExit(f"no class directories under {src}")
    print(f"{len(classes)} classes", file=sys.stderr)
    for label, cls in enumerate(classes):
        cdir = os.path.join(src, cls)
        for name in sorted(os.listdir(cdir)):
            if os.path.splitext(name)[1].lower() in EXTS:
                yield os.path.join(cdir, name), label


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def main(argv: Optional[List[str]] = None) -> str:
    """Pack one split; returns the file's path."""
    from pytorch_distributed_tpu_torch.data.imagenet import write_imagenet_split
    from pytorch_distributed_tpu_torch.data.packed_record import PackedRecordReader
    from pytorch_distributed_tpu_torch.data.raw import write_imagenet_raw_split

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="ImageFolder-layout directory")
    p.add_argument("out", help="output directory for the packed split")
    p.add_argument("--split", default="train", help="split name (file stem)")
    p.add_argument("--raw", action="store_true", help="pre-decode to uint8 (the fast path)")
    p.add_argument("--image-size", type=int, default=256,
                   help="raw mode: stored square size (shorter-side resize + center crop)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    samples = ((_read(f), label) for f, label in iter_images(args.src))
    t0 = time.time()
    if args.raw:
        path = os.path.join(args.out, f"{args.split}.rawtprc")
        n = write_imagenet_raw_split(path, samples, image_size=args.image_size)
    else:
        path = os.path.join(args.out, f"{args.split}.tprc")
        n = write_imagenet_split(path, samples)
    print(f"packed {n} records -> {path} ({os.path.getsize(path) / 2**20:.0f} MB, "
          f"{time.time() - t0:.0f}s)", file=sys.stderr)
    with PackedRecordReader(path) as reader:
        reader.verify_all()
    print("integrity sweep OK", file=sys.stderr)
    return path


if __name__ == "__main__":
    main()
