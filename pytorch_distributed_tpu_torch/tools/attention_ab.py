"""Kernel 6's split backward, kernel 7's single sweep and kernel 8's split
(on bf16 pools, and on fp8 and int8 pools with bf16 q) of two checkouts,
timed on one card in turns.

    python -m pytorch_distributed_tpu_torch.tools.attention_ab --parent DIR [--rounds 2]

``DIR`` is another checkout of the repository (say the parent commit,
unpacked with ``git archive`` into an ignored directory). As
``tools/tail_ab.py`` does, each round runs the parent, this checkout, this
checkout again and the parent, each in a process of its own that imports
the package from its checkout and builds that checkout's kernels. Each
process times, through the public wrappers and with ``chip_smoke.py``'s
operands and timers (CUDA events over the calls, the L2 flushed before
each):

- the split backward (``flash_backward(..., bwd_impl="split")``: Δ, the
  dK/dV kernel, the dQ kernel) at the training shape (B 8, L 2048, H 12,
  D 64, causal, bf16), and its two kernels' device times from a
  ``torch.profiler`` trace;
- the single sweep (``paged_flash_attention(..., split_s=1)``) on bf16
  pools at the decode shape (B 8, C 1, H 12, W 128) and at the serve's
  prefill chunk (B 4 x C 32, W 64);
- the flash-decoding split on bf16 pools at the decode shape with the
  auto policy's S = 8, as every decode tick of the serve runs it: the call,
  and its kernel's device time (``is_split_kernel``: the split's CUDA
  function, either checkout's);
- the same sweep and split (the auto policy's S = 8, which a serve's
  prefill chunks take too) at both shapes on fp8 e4m3 and int8 pools,
  quantized by the plain ``quantize_kv`` from
  ``chip_smoke.py``'s fp32 operands, with bf16 q: each call, and its
  kernel's device time (``is_sweep_kernel``, ``is_split_kernel``: the
  tensor-core kernel or the CUDA-core walk, whichever the checkout runs),
  every launch of the traced calls counted;
- on those fp8 and int8 pools, a layer's step with its new rows
  (``with_new_rows``): kernel 9 then the split at decode or the sweep at
  the prefill chunk, and the append route (``paged_quantize_scatter_
  attention``, one launch) where the checkout has it.

The last line printed is the median of each (checkout, entry) over its
runs, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__:
    from pytorch_distributed_tpu_torch.tools import tail_ab
else:  # a worker run as a script imports its own checkout's package below
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import tail_ab


def worker(checkout: str) -> dict:
    """Times, in µs, for the package of ``checkout`` (this process imports
    it from there)."""
    sys.path.insert(0, checkout)
    import torch

    from pytorch_distributed_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_tpu_torch.ops import paged_flash as pf

    cs = tail_ab._load_chip_smoke(tail_ab.THIS)  # operands and timers: this checkout's
    bf16 = torch.bfloat16

    def device_us(call, match):
        """The matched kernel's device time a call, or None (said on stderr)
        when no trace held every launch."""
        try:
            return cs.kernel_device_ms(torch, call, {"k": (match, 1)})["k"] * 1e3
        except RuntimeError as e:
            print(f"attention_ab: no device time: {e}", file=sys.stderr)
            return None

    q, k, v, do = cs.flash_inputs(torch, bf16, seed=7)
    sc = q.shape[-1] ** -0.5
    o, lse = fa.flash_forward(q, k, v, causal=True, scale=sc)

    def split():
        return fa.flash_backward(q, k, v, o, lse, do, causal=True, scale=sc, bwd_impl="split")

    out = {"split backward call": cs.time_ms(torch, split, iters=20) * 1e3}
    dev = cs.kernel_device_ms(torch, split, {"dQ": (cs.is_dq_kernel, 1),
                                             "dK/dV": (cs.is_dkv_kernel, 1)})
    out.update({f"{name} kernel (device)": ms * 1e3 for name, ms in dev.items()})
    del q, k, v, do, o, lse
    for label, inp in (("decode", cs.decode_inputs(torch, bf16)),
                       ("prefill chunk", cs.prefill_inputs(torch, bf16))):
        out[f"sweep at {label}"] = cs.time_ms(
            torch, lambda: pf.paged_flash_attention(**inp, split_s=1)) * 1e3
    decode = cs.decode_inputs(torch, bf16)

    def paged_split():
        return pf.paged_flash_attention(**decode)

    out["split at decode (S = 8)"] = cs.time_ms(torch, paged_split) * 1e3
    out["split kernel at decode (device)"] = device_us(paged_split, is_split_kernel)
    for kv in ("fp8", "int8"):
        for label, raw in (("decode", cs.decode_inputs(torch, torch.float32, seed=5)),
                           ("prefill chunk", cs.prefill_inputs(torch, torch.float32, seed=5))):
            inp = cs.quantized(torch, raw, kv)
            inp["q"] = inp["q"].to(bf16)
            for name, split_s, match in (("sweep", 1, is_sweep_kernel),
                                         ("split", None, is_split_kernel)):
                def call():
                    return pf.paged_flash_attention(**inp, split_s=split_s)
                at = f"{kv} {name} at {label}" + (" (S = 8)" if split_s is None else "")
                out[at] = cs.time_ms(torch, call) * 1e3
                out[f"{kv} {name} kernel at {label} (device)"] = device_us(call, match)
            out.update(with_new_rows(torch, pf, cs, kv, label, inp, device_us))
    return out


def with_new_rows(torch, pf, cs, kv, label, inp, device_us) -> dict:
    """A quantized layer's serving step on ``inp``, its new rows (``chip_
    smoke.new_rows``) written at the call's positions, then the attention
    the serve runs there (the split, S = 8, at decode; the sweep at the
    prefill chunk): kernel 9 then that kernel, in either checkout, and the
    append route (one launch) where the checkout has it (None where not).
    Each call, and the device time of its kernels (kernel 9's also alone)."""
    name, split_s, match = (("split", None, is_split_kernel) if label == "decode"
                            else ("sweep", 1, is_sweep_kernel))
    k, v = cs.new_rows(torch, inp, seed=16)
    pools = (inp["k_pool"], inp["v_pool"], inp["k_scale"], inp["v_scale"])
    pos = inp["q_positions"].long()
    bl = inp["k_pool"].shape[1]
    blk = torch.gather(inp["block_tables"].long(), 1, pos // bl)

    def two_launches():
        pf.paged_quantize_scatter(k, v, blk, pos % bl, *pools)
        return pf.paged_flash_attention(**inp, split_s=split_s)

    two = f"{kv} kernel 9 then {name} at {label}"
    out = {two: cs.time_ms(torch, two_launches) * 1e3}
    try:
        dev = cs.kernel_device_ms(torch, two_launches, {"k": (match, 1), "q": (
            lambda n: "quantize_scatter" in n, 1)})
        out[f"{two} (device)"] = (dev["k"] + dev["q"]) * 1e3
        out[f"{kv} kernel 9 at {label} (device)"] = dev["q"] * 1e3
    except RuntimeError as e:
        print(f"attention_ab: no device time: {e}", file=sys.stderr)
        out[f"{two} (device)"] = out[f"{kv} kernel 9 at {label} (device)"] = None
    op = getattr(pf, "paged_quantize_scatter_attention", None)
    at = f"{kv} append {name} at {label}"
    out[at] = out[f"{at} (device)"] = None
    if op is not None:
        def append():
            return op(inp["q"], k, v, *pools, inp["block_tables"], inp["q_positions"],
                      split_s=split_s)
        out[at] = cs.time_ms(torch, append) * 1e3
        out[f"{at} (device)"] = device_us(append, match)
    return out


def is_split_kernel(name: str) -> bool:
    """Kernel 8's CUDA function in a profiler trace: ``paged_split_tc_kernel``
    (bf16 q on bf16 pools, and on int8 and fp8 pools in a checkout that
    routes them there), or the CUDA-core walk's split instantiation
    (``paged_attention_kernel<..., true>``; a trace may also give it
    mangled, ``...Lb1EEE...``)."""
    return "paged_split_tc" in name or ("paged_attention_kernel" in name
                                        and ("true>" in name or "Lb1E" in name))


def is_sweep_kernel(name: str) -> bool:
    """Kernel 7's CUDA function in a profiler trace: ``paged_sweep_tc_kernel``
    or the CUDA-core walk's sweep instantiation
    (``paged_attention_kernel<..., false>``, or mangled ``...Lb0EEE...``)."""
    return "paged_sweep_tc" in name or ("paged_attention_kernel" in name
                                        and ("false>" in name or "Lb0E" in name))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="the other checkout's root")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return {}
    return tail_ab.compare(__file__, args.parent, args.rounds)


if __name__ == "__main__":
    main()
