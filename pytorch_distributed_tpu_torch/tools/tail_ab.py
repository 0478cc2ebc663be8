"""The bottleneck tail's kernels of two checkouts, timed on one card in turns.

    python -m pytorch_distributed_tpu_torch.tools.tail_ab --parent DIR [--rounds 2]

``DIR`` is another checkout of the repository (say the parent commit,
unpacked with ``git archive`` into an ignored directory). Each round runs
the parent, this checkout, this checkout again and the parent, each in a
process of its own that imports the package from its checkout and builds
that checkout's ``csrc/bottleneck_tail.cu``. Each process times
``moments``, ``tail_bwd_reduce`` and ``tail_bwd_dz`` through their public
wrappers at ResNet-50's four expand-tail shapes, and ``moments`` also at
the four downsample inputs (``chip_smoke.py``'s ``tail_shapes``: z ``[128,
H, W, F]``, E = 4F, bf16, the operands of its ``tail_inputs``), each by
CUDA events over 20 calls with the L2 flushed before each (its
``time_ms``) and by its kernels' device time in a profiler trace (its
``kernel_device_ms``, every launch of a call counted; the kernels named by
this checkout's ``ops.bottleneck_tail.kernel_of``, which knows an older
build's names too), and prints one JSON line. The last line
printed is the median of each (checkout, entry) over its runs, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]


def _load(name: str, path: Path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load_chip_smoke(root: Path):
    return _load("chip_smoke", root / "chip_smoke.py")


def worker(checkout: str) -> dict:
    """Times, in µs, of each kernel at each of ``chip_smoke.py``'s
    ``tail_shapes``: the call ("kernel label") and its kernels' device time
    ("kernel label, device"), for the package of ``checkout`` (this process
    imports it from there)."""
    sys.path.insert(0, checkout)
    import torch

    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

    # the timer, the operands and the kernels' names: this checkout's
    cs = _load_chip_smoke(THIS)
    this_bt = _load("tail_kernel_names",
                  THIS / "pytorch_distributed_tpu_torch" / "ops" / "bottleneck_tail.py")
    out = {}
    for label, (b, hw, f), names in cs.tail_shapes():
        z, g, o, wa, c, dmn = cs.tail_inputs(torch, torch.bfloat16, b, hw, f, seed=11)
        gp = bt.tail_bwd_reduce(z, g, o)[0]
        calls = {"moments": lambda: bt.moments(z),
                 "tail_bwd_reduce": lambda: bt.tail_bwd_reduce(z, g, o),
                 "tail_bwd_dz": lambda: bt.tail_bwd_dz(gp, z, wa, c, dmn)}
        for name in names:
            out[f"{name} {label}"] = cs.time_ms(torch, calls[name], iters=20) * 1e3
            match = {name: (lambda k: this_bt.kernel_of(k) == name, cs.TAIL_LAUNCHES[name])}
            out[f"{name} {label}, device"] = cs.kernel_device_ms(
                torch, calls[name], match)[name] * 1e3
        del z, g, o, gp
        torch.cuda.empty_cache()
    return out


def median_of(values):
    """The median of the values a worker measured (None where it could not
    measure one), or None if no run measured it."""
    got = [v for v in values if v is not None]
    return statistics.median(got) if got else None


def compare(script: str, parent: str, rounds: int) -> dict:
    """Run ``script --worker ROOT`` (a tool whose worker prints one JSON
    line of times) for the parent, this checkout, this checkout again and
    the parent, ``rounds`` times, each in a process of its own; print each
    run's line, then the median of each (checkout, entry) with the card's
    name and power limit, and return that summary."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    roots = {"parent": str(Path(parent).resolve()), "change": str(THIS)}
    runs = {name: [] for name in roots}
    for r in range(rounds):
        for name in ("parent", "change", "change", "parent"):
            try:
                res = subprocess.run([sys.executable, script, "--parent", roots["parent"],
                                      "--worker", roots[name]],
                                     capture_output=True, text=True, check=True,
                                     env=dict(os.environ, PYTHONPATH=""))
            except subprocess.CalledProcessError as e:  # the worker's own error first
                print(f"{name} worker failed:\n{(e.stderr or '')[-6000:]}", file=sys.stderr)
                raise
            times = json.loads(res.stdout.strip().splitlines()[-1])
            runs[name].append(times)
            print(json.dumps({"round": r, "checkout": name, "us": times}))
    summary = {"card": card, "median_us": {
        name: {k: median_of(t[k] for t in ts) for k in ts[0]} for name, ts in runs.items()}}
    print(json.dumps(summary))
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="the other checkout's root")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return {}
    return compare(__file__, args.parent, args.rounds)

if __name__ == "__main__":
    main()
