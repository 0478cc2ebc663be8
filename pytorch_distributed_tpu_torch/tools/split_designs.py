"""Kernel 8's two designs on one card: the shipped bf16 split against the
whole-pool-block one.

    python -m pytorch_distributed_tpu_torch.tools.split_designs

At the serve's decode shape (``chip_smoke.py``'s ``decode_inputs``: B 8,
H = H_kv = 12, D 64, W 128 blocks of 16, bf16, the auto policy's S = 8),
and with every chain full (2,048 keys):

- the shipped ``paged_split_tc_kernel`` through ``paged_flash_attention``:
  one block per (worker, KV head, batch row), per-head TMA boxes (64, 1,
  16), mma.sync products;
- ``tools/split_whole_blocks.cu``: one block per (worker, batch row) owning
  all heads, whole pool blocks landed by one bulk copy or one TMA box (64,
  12, 16) each, CUDA-core products; four variants (copy kind x ring depth).

Each output is held against the plain version (bf16 tolerance 2e-2) and
bit for bit over two launches; each is timed by CUDA events over the call
with the L2 flushed before each (``chip_smoke.time_ms``) and by its kernel's
device time in a ``torch.profiler`` trace (``chip_smoke.kernel_device_ms``).
The last line printed is one JSON object of the times in µs, with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import torch

from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops import paged_flash as pf
from pytorch_distributed_tpu_torch.ops.attention import paged_attention_reference
from pytorch_distributed_tpu_torch.tools import tail_ab

SOURCE = Path(__file__).resolve().with_name("split_whole_blocks.cu")
VARIANTS = {0: "bulk copy, 4 stages, 1 block an SM", 1: "TMA box, 4 stages, 1 block an SM",
            2: "bulk copy, 2 stages, 2 blocks an SM", 3: "TMA box, 2 stages, 2 blocks an SM"}
BF16_TOL = 2e-2


def build() -> ctypes.CDLL:
    """The whole-block variant's library, built with the package's nvcc
    flags into the package's build directory."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libsplit_whole_blocks.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(out), str(SOURCE)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pdt_split_wb.argtypes = [p, p, p, i, p, p, p, p, p, p, p, i, i, i, i, i,
                                 ctypes.c_float, i, p]
    lib.pdt_split_wb.restype = i
    return lib


def main() -> dict:
    cs = tail_ab._load_chip_smoke(tail_ab.THIS)  # operands and timers
    card = cs.card_line()
    lib = build()
    bf16 = torch.bfloat16
    out = {"card": card}
    for label, kw in (("decode", {}), ("decode, every chain full", dict(positions=[[2047]] * 8))):
        inp = cs.decode_inputs(torch, bf16, **kw)
        ref = paged_attention_reference(**inp)
        b, _, h, d = inp["q"].shape
        n_blocks, bl = inp["k_pool"].shape[:2]
        w = inp["block_tables"].shape[1]
        s_workers = pf.auto_split_s(w, b)
        f32 = dict(device="cuda", dtype=torch.float32)
        acc, m, l = (torch.empty((b, h, s_workers, d), **f32), torch.empty((b, h, s_workers), **f32),
                     torch.empty((b, h, s_workers), **f32))
        tickets = torch.zeros(b, dtype=torch.int32, device="cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def whole_blocks(variant):
            o = torch.empty_like(inp["q"])
            code = lib.pdt_split_wb(
                inp["q"].data_ptr(), inp["k_pool"].data_ptr(), inp["v_pool"].data_ptr(),
                n_blocks, inp["block_tables"].data_ptr(), inp["q_positions"].data_ptr(),
                o.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), tickets.data_ptr(),
                b, h, bl, w, s_workers, d ** -0.5, variant, stream)
            if code != 0:
                raise RuntimeError(f"split_whole_blocks variant {variant}: error {code}")
            return o

        calls = {"shipped: paged_split_tc_kernel": (
            lambda: pf.paged_flash_attention(**inp), cs.is_split_kernel)}
        calls.update({f"whole blocks: {name}": (lambda v=v: whole_blocks(v),
                                                lambda k: "split_wb" in k)
                      for v, name in VARIANTS.items()})
        for name, (fn, match) in calls.items():
            got = fn()
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            if not err <= BF16_TOL or not torch.equal(fn(), fn()):
                raise SystemExit(f"split_designs: {name} at {label}: error {err:.3e} or "
                                 "two launches differ")
            out[f"{label}, {name}"] = {
                "call_us": cs.time_ms(torch, fn) * 1e3,
                "device_us": cs.kernel_device_ms(torch, fn, {"k": (match, 1)})["k"] * 1e3,
                "max_abs_err": err}
        out[f"{label}, bound_us"] = cs.bound(inp)["bound_ms"] * 1e3
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
