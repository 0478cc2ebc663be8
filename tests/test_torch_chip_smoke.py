"""``chip_smoke.py``'s phases rehearsed on the CPU.

The script runs only on the card, so its control flow is checked here at
small shapes: the kernel checks of phase (b) and the timings of phase (d)
run against the plain versions (``dev="cpu"``), with the card's timer
replaced; the bounds are checked against the shapes' arithmetic.
"""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "TAIL_STAGES", ((2, 8, 64), (2, 4, 128), (2, 4, 256), (2, 2, 512)))
    monkeypatch.setattr(cs, "TAIL_DOWNSAMPLE",
                        ((2, 8, 64), (2, 4, 256), (2, 4, 512), (2, 2, 1024)))
    monkeypatch.setattr(cs, "time_ms", lambda torch, fn, iters=100, warmup=5: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "kernel_device_ms",
                        lambda torch, fn, match, iters=10: (fn(), {k: 0.5 for k in match})[1])
    return cs


def test_tail_checks_and_timings_rehearse_on_cpu(chip_smoke, capsys):
    failures = []
    errs = chip_smoke.check_tail_kernels(torch, failures, dev="cpu")
    assert failures == []
    assert set(errs) == {bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ}
    out = capsys.readouterr().out
    # gp: 4 stages x 2 dtypes + 2 ragged x 2 dtypes, the 4 stages at the DP
    # phase's 3 batches (B = 32 bf16 and fp32, the concatenated 64 fp32), and
    # z and out rows wider than their channels
    assert out.count("bit-equal") == 25
    # moments at 33 shapes (the 24 above, 4 downsample inputs at B = 128 and
    # at the 3 DP batches, wide z rows), tail_bwd_reduce at 25 (the 24 and
    # wide rows) and tail_bwd_dz at 24, each launched twice and compared bit
    # for bit
    assert out.count("two launches bitwise equal") == 90
    for dp in ("DP B=32", "DP concatenated B=64"):
        assert f"stage 4, {dp}" in out and f"downsample input of stage 4, {dp}" in out
    wide = [line for line in out.splitlines() if "rows 16 bytes wider than their channels" in line]
    assert {line.split()[1].rstrip(",") for line in wide} == {bt.MOMENTS, bt.BWD_REDUCE,
                                                              bt.BWD_DZ}
    assert "FAIL" not in out
    entries = chip_smoke.time_tail_kernels(torch, "CPU", dev="cpu")
    assert set(entries) == {bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ}
    stages = [f"stage {i}" for i in range(1, 5)]
    downsample = [f"downsample input of stage {i}" for i in range(1, 5)]
    for name, entry in entries.items():
        assert set(entry) == {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "spelling_ms", "kernel", "device_ms", "stages"}
        assert entry["library_ms"] is None and entry["bound_ms"] > 0
        # every stage (moments also every downsample input), each with its
        # kernels' device time beside the call, the plain version, the
        # spelling and the bound
        want = stages + downsample if name == bt.MOMENTS else stages
        assert sorted(entry["stages"]) == sorted(want)
        for st in entry["stages"].values():
            assert st["device_ms"] == 0.5 and st["bound_ms"] > 0
            assert {"ms", "plain_ms", "spelling_ms", "bound_by"} <= set(st)
            assert ("merge_ms" in st) == (name != bt.BWD_DZ)
    out = capsys.readouterr().out
    assert out.count("tail_bwd_dz at stage") == out.count("tail_bwd_reduce at stage") == 4
    assert out.count("moments at stage") == 4 and out.count("moments at downsample") == 4


def test_tail_bounds_at_resnet50_stage_shapes(chip_smoke):
    """Stage 1 (z [401408, 64], E 256) is bound by bytes; at stage 4 (z
    [6272, 512], E 2048) tail_bwd_dz by bf16 operations, moments by bytes:
    its product is the upper triangle of zᵀz, F(F+1)/2 sums a row, which
    bounds it by operations only at the widest downsample input (z [6272,
    1024])."""
    bf16 = torch.bfloat16
    s1 = {k: chip_smoke.tail_bound(k, 401408, 64, 256, 2, bf16)
          for k in (bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ)}
    assert s1[bt.MOMENTS]["bytes"] == 401408 * 64 * 2 + (64 + 64 * 64) * 4
    assert s1[bt.BWD_REDUCE]["bytes"] == 401408 * (64 + 3 * 256) * 2 + (64 * 256 + 256) * 4
    assert s1[bt.BWD_DZ]["flops"] == 2 * 401408 * 320 * 64
    assert all(v["bound_by"] == "bytes" for v in s1.values())
    assert s1[bt.BWD_REDUCE]["bound_ms"] == pytest.approx(0.1994, rel=1e-3)
    assert s1[bt.MOMENTS]["flops"] == 2 * 401408 * (64 * 65 // 2)
    s4 = {k: chip_smoke.tail_bound(k, 6272, 512, 2048, 2, bf16)
          for k in (bt.MOMENTS, bt.BWD_DZ)}
    assert s4[bt.BWD_DZ]["bound_by"] == "operations"
    assert s4[bt.BWD_DZ]["bound_ms"] == pytest.approx(2 * 6272 * 2560 * 512 / 989e12 * 1e3)
    assert s4[bt.MOMENTS]["flops"] == 6272 * 512 * 513
    assert s4[bt.MOMENTS]["bound_by"] == "bytes"
    assert s4[bt.MOMENTS]["bound_ms"] == pytest.approx(
        (6272 * 512 * 2 + (512 + 512 * 512) * 4) / 3.35e12 * 1e3)
    widest = chip_smoke.tail_bound(bt.MOMENTS, 6272, 1024, 4096, 2, bf16)
    assert widest["bound_by"] == "operations"
    assert widest["bound_ms"] == pytest.approx(6272 * 1024 * 1025 / 989e12 * 1e3)


def test_split_backward_checks_rehearse_on_cpu(chip_smoke, monkeypatch, capsys):
    """Kernel 6's check phase on CPU tensors, where the wrappers run the
    plain version: every shape of ``SPLIT_CHECKS`` (the training and ring
    shapes cut to L = 70, the zigzag chunk views kept) passes, with dK and
    dV bitwise equal to the fused path's, repeats bitwise and reports both
    kernels' errors."""
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    def cut(shape):
        if shape.get("l", 2048) < 1024:
            return shape
        return dict(b=1, l=70, h=2, **{k: x for k, x in shape.items() if k == "view"})

    small = tuple((label, dt, causal, shift, cut(shape))
                  for label, dt, causal, shift, shape in chip_smoke.SPLIT_CHECKS)
    assert sum("view" in shape for *_, shape in small) == 2
    monkeypatch.setattr(chip_smoke, "SPLIT_CHECKS", small)
    failures = []
    errs = chip_smoke.check_split_kernels(torch, failures, dev="cpu")
    assert failures == []
    assert set(errs) == {fa.BWD_DKV, fa.BWD_DQ}
    out = capsys.readouterr().out
    assert out.count("two launches bitwise equal") == 2 * len(small) == 34  # split, fused
    assert out.count("split vs fused") == 3 * len(small)
    assert out.count("bitwise equal") == 4 * len(small)  # repeats, and dK, dV vs fused
    assert "FAIL" not in out


def _unrepeatable(fn, index):
    """``fn`` with a different tiny offset on output ``index`` each call, as
    a kernel that sums in a varying order would give."""
    calls = []

    def wrapped(*args, **kw):
        calls.append(1)
        out = list(fn(*args, **kw))
        out[index] = out[index] + len(calls) * 1e-7 * out[index].abs().max().clamp_min(1.0)
        return tuple(out)

    return wrapped


@pytest.mark.parametrize("kernel", ["moments", "tail_bwd_reduce"])
def test_tail_repeat_check_fails_a_kernel_that_does_not_repeat(chip_smoke, monkeypatch,
                                                               capsys, kernel):
    """A planted stub whose two launches differ fails the tail phase's
    repeat check, though it stays within the tolerance of the plain
    version."""
    monkeypatch.setattr(chip_smoke, "TAIL_STAGES", chip_smoke.TAIL_STAGES[:1])
    monkeypatch.setattr(chip_smoke, "TAIL_DOWNSAMPLE", ())
    monkeypatch.setattr(bt, kernel, _unrepeatable(getattr(bt, kernel), -1))  # m2, or Σgp
    failures = []
    chip_smoke.check_tail_kernels(torch, failures, dev="cpu")
    assert failures and all(f.startswith(kernel) and f.endswith("repeat") for f in failures)
    assert "differ in" in capsys.readouterr().out


def test_flash_repeat_check_fails_a_fused_backward_that_does_not_repeat(chip_smoke,
                                                                      monkeypatch):
    """The same for the fused flash backward in the split phase: only its
    repeat check fails (its dQ stays within tolerance of the split one)."""
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    real = fa.flash_backward
    fused = _unrepeatable(lambda *a, **kw: real(*a, **kw), 0)  # dQ

    def planted(*args, bwd_impl="fused", **kw):
        if bwd_impl == "fused":
            return fused(*args, bwd_impl=bwd_impl, **kw)
        return real(*args, bwd_impl=bwd_impl, **kw)

    monkeypatch.setattr(fa, "flash_backward", planted)
    monkeypatch.setattr(chip_smoke, "SPLIT_CHECKS", tuple(
        (label, dt, causal, shift, dict(b=1, l=70, h=2, seed=1))
        for label, dt, causal, shift, shape in chip_smoke.SPLIT_CHECKS[6:8]))
    failures = []
    chip_smoke.check_split_kernels(torch, failures, dev="cpu")
    assert len(failures) == 2 and all(f.startswith("fused bwd") and f.endswith("repeat")
                                      for f in failures)


def test_split_backward_check_takes_a_zigzag_visit_as_the_ring_does(chip_smoke, monkeypatch):
    """The zigzag cases hand the split backward strided half-shard views
    and a precomputed, sliced Δ, as ``ops/ring_flash.py`` does."""
    from pytorch_distributed_tpu_torch.ops import flash_attention as fa

    seen = []
    real = fa.flash_backward

    def spy(q, k, v, o, lse, do, **kw):
        seen.append((q.is_contiguous(), k.is_contiguous(), q.shape[1], k.shape[1],
                     kw.get("delta")))
        return real(q, k, v, o, lse, do, **kw)

    monkeypatch.setattr(fa, "flash_backward", spy)
    monkeypatch.setattr(chip_smoke, "SPLIT_CHECKS", tuple(
        (label, dt, causal, shift, dict(b=2, l=70, h=2, view=shape["view"]))
        for label, dt, causal, shift, shape in chip_smoke.SPLIT_CHECKS if "view" in shape))
    failures = []
    chip_smoke.check_split_kernels(torch, failures, dev="cpu")
    assert failures == [] and len(seen) == 8  # split and fused twice each, two cases
    for q_contig, k_contig, lq, lk, delta in seen:
        assert not q_contig and not k_contig and lq == lk == 35
        assert delta is not None and delta.shape[-1] == 35 and not delta.is_contiguous()


def test_split_backward_bound_at_the_training_shape(chip_smoke):
    """B 8, L 2048, H 12, D 64, causal bf16: 14·D flops per visible pair
    against the fused kernel's 10·D, so 1.4 x its 130.3 µs; the two split
    kernels' products add up to the pair's."""
    q = torch.empty(8, 2048, 12, 64, dtype=torch.bfloat16, device="meta")
    fb = chip_smoke.flash_bound(q, q)
    pairs = 8 * 12 * 2048 * 2049 / 2
    assert fb["bwd_split"]["flops"] == 14 * 64 * pairs
    assert fb["bwd_split"]["flops"] == fb["bwd_dkv"]["flops"] + fb["bwd_dq"]["flops"]
    assert all(fb[k]["bound_by"] == "operations" for k in ("bwd_split", "bwd_dkv", "bwd_dq"))
    assert fb["bwd_split"]["bound_ms"] == pytest.approx(14 * 64 * pairs / 989e12 * 1e3)
    assert fb["bwd_split"]["bound_ms"] == pytest.approx(0.1825, rel=1e-3)
    assert fb["bwd_split"]["bound_ms"] / fb["bwd"]["bound_ms"] == pytest.approx(1.4)


def test_ring_phase_rehearses_on_cpu(chip_smoke, monkeypatch, tmp_path, capsys):
    """The ring phase end to end with CPU ranks over gloo at a small size
    (2 layers, 2 heads of 64, L = 64, B = 2, 2 steps): the four
    ``ring_flash_attention`` cases against one device, then the trainer in
    both layouts with its first step against the one-device flash step."""
    monkeypatch.setattr(chip_smoke, "RING", dict(batch=2, seq=64, steps=2, timeout_s=120))
    monkeypatch.setattr(chip_smoke, "RING_MODEL", dict(vocab_size=128, num_layers=2,
                                                       num_heads=2, embed_dim=128))
    out = chip_smoke.ring_runs(torch, "CPU", str(tmp_path), dev="cpu")
    text = capsys.readouterr().out
    assert "backend gloo, 2 ranks on 1 card" in text
    assert text.count(" ok\n") == 4 and "FAIL" not in text
    assert text.count("first step vs one card") == 2
    assert set(out["trainer_launches"]) == {"contiguous", "zigzag"}
    assert all(n == 0 for n in out["split_launches"].values())  # plain versions


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_ring_launch_expectations_follow_the_ring_schedule(chip_smoke, ranks):
    """The forward launches chip_smoke expects on each rank (a formula)
    equal the kernel calls the port's ring schedules, in both layouts."""
    from pytorch_distributed_tpu_torch.ops.ring_flash import _visits

    for layout in ("contiguous", "zigzag"):
        scheduled = [sum(len(_visits(layout, True, my, (my - step) % ranks))
                         for step in range(ranks)) for my in range(ranks)]
        assert chip_smoke.ring_launches(layout, ranks) == scheduled


class _FakeTrace:
    """A ``torch.profiler.profile`` stand-in whose traces are given: each
    ``with`` block yields the next list of (kernel name, launches, µs)."""

    def __init__(self, traces):
        self.traces, self.taken = list(traces), 0

    def __call__(self, activities):
        return self

    def __enter__(self):
        self.events = [types.SimpleNamespace(key=k, count=n, self_device_time_total=us)
                       for k, n, us in self.traces[self.taken]]
        self.taken += 1
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return self.events


def _unpatched_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _fake_card():
    flush = types.SimpleNamespace(zero_=lambda: None)
    return types.SimpleNamespace(empty=lambda *a, **k: flush, uint8=None,
                                 cuda=types.SimpleNamespace(synchronize=lambda: None))


TAIL_MATCH = {"moments": (lambda k: bt.kernel_of(k) == bt.MOMENTS, 2),
              "merge": (lambda k: "tail_merge" in k, 1)}
FULL = [("tail_reduce_wgmma_kernel<false, 1, 1, 64, 12>", 10, 300.0),
        ("tail_merge_kernel<false>", 10, 30.0), ("fill_kernel", 10, 5.0)]


@pytest.mark.parametrize("traces, want_taken", [
    ([FULL], 1),
    # the profiler dropped the reduction (0.0 would read as time), then a merge
    ([FULL[1:], [FULL[0], ("tail_merge_kernel<false>", 9, 27.0)], FULL], 3),
])
def test_device_times_count_every_launch(monkeypatch, traces, want_taken):
    """``kernel_device_ms`` returns per-call means only from a trace that
    holds every launch of the calls (10 calls of 2 kernels for moments: the
    reduction and its merge), taking the trace again when launches are
    missing."""
    import torch.profiler

    trace = _FakeTrace(traces)
    monkeypatch.setattr(torch.profiler, "profile", trace)
    got = _unpatched_chip_smoke().kernel_device_ms(_fake_card(), lambda: None, TAIL_MATCH)
    assert trace.taken == want_taken
    assert got == pytest.approx({"moments": 0.033, "merge": 0.003})


def test_device_times_raise_when_launches_stay_missing(monkeypatch):
    """Six traces short of launches (or with extra ones) raise, naming the
    counts, and no time is returned."""
    import torch.profiler

    short = [FULL[0], ("tail_merge_kernel<false>", 9, 27.0)]
    extra = [FULL[0], ("tail_merge_kernel<false>", 11, 33.0)]
    trace = _FakeTrace([short, extra, short, extra, short, extra])
    monkeypatch.setattr(torch.profiler, "profile", trace)
    with pytest.raises(RuntimeError, match="not {'moments': 20, 'merge': 10}"):
        _unpatched_chip_smoke().kernel_device_ms(_fake_card(), lambda: None, TAIL_MATCH)
    assert trace.taken == 6


@pytest.mark.parametrize("cards, want", [(0, (2, "gloo")), (1, (2, "gloo")), (2, (2, "nccl")),
                                         (4, (4, "nccl")), (8, (4, "nccl"))])
def test_ring_phase_takes_its_ranks_from_the_cards(chip_smoke, cards, want):
    """Two ranks share one card (or the CPU) over gloo; with more cards,
    one rank a card, up to 4, over NCCL."""
    assert chip_smoke.ring_ranks(cards) == want


@pytest.mark.parametrize("kernel, kind", [
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel<1, 3, 3>(CUtensorMap, CUtensorMap, "
     "CUtensorMap, (anonymous namespace)::FwdArgs)", "flash forward"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 64>((anonymous namespace)::Params)",
     "flash forward"),
    ("void (anonymous namespace)::flash_bwd_wgmma_kernel<1, 2, true>(CUtensorMap, CUtensorMap, "
     "CUtensorMap, CUtensorMap, (anonymous namespace)::BwdArgs)", "flash backward"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<float, 64>(Params)",
     "flash backward"),
    ("void (anonymous namespace)::flash_bwd_dq_wgmma_kernel<1, 3, 2>(CUtensorMap, CUtensorMap, "
     "CUtensorMap, CUtensorMap, (anonymous namespace)::BwdArgs)", "flash backward"),
    ("void (anonymous namespace)::tail_reduce_kernel<__nv_bfloat16, false>(...)", "tail moments"),
    ("void (anonymous namespace)::tail_sum_kernel<true>(float const*, int, int, int, float*, "
     "float*)", "tail moments"),
    ("void (anonymous namespace)::tail_reduce_kernel<__nv_bfloat16, true>(...)",
     "tail_bwd_reduce"),
    ("void (anonymous namespace)::tail_sum_kernel<false>(float const*, int, int, int, float*, "
     "float*)", "tail_bwd_reduce"),
    ("void (anonymous namespace)::tail_dz_kernel<__nv_bfloat16>(...)", "tail_bwd_dz"),
    ("void (anonymous namespace)::tail_dz_kernel<float>(...)", "tail_bwd_dz"),
    ("void (anonymous namespace)::tail_dz_wgmma_kernel<1, 8>(CUtensorMap, CUtensorMap, "
     "CUtensorMap, CUtensorMap, (anonymous namespace)::DzArgs)", "tail_bwd_dz"),
    ("void (anonymous namespace)::tail_reduce_wgmma_kernel<false, 1, 1, 64, 12>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, (anonymous namespace)::ReduceArgs)", "tail moments"),
    ("void (anonymous namespace)::tail_reduce_wgmma_kernel<false, 2, 2, 64, 6>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, (anonymous namespace)::ReduceArgs)", "tail moments"),
    ("void (anonymous namespace)::tail_reduce_wgmma_kernel<true, 1, 4, 64, 3>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, (anonymous namespace)::ReduceArgs)",
     "tail_bwd_reduce"),
    ("void (anonymous namespace)::tail_reduce_wgmma_kernel<true, 8, 1, 32, 5>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, (anonymous namespace)::ReduceArgs)",
     "tail_bwd_reduce"),
    ("void (anonymous namespace)::tail_merge_kernel<false>(float const*, int, int, int, float*, "
     "float*)", "tail moments"),
    ("void (anonymous namespace)::tail_merge_kernel<true>(float const*, int, int, int, float*, "
     "float*)", "tail_bwd_reduce"),
    ("void (anonymous namespace)::tail_reduce_kernel<false>(float const*, long, float const*, "
     "long, float const*, long, float*, float*, int, int, int, int)", "tail moments"),
    ("void (anonymous namespace)::tail_reduce_kernel<true>(float const*, long, float const*, "
     "long, float const*, long, float*, float*, int, int, int, int)", "tail_bwd_reduce"),
])
def test_profiles_name_every_kernel_of_the_port(chip_smoke, kernel, kind):
    """``profile_train.kind_of`` files each kernel of the flash and tail
    sources, the wgmma kernels and the tail's merges and chunk sums (an older
    build's, as ``tools/tail_ab.py`` times a parent) included, under its
    kernel, not under "other"; ``bottleneck_tail.kernel_of``, which both
    it and chip_smoke's device-time matches read, names the same tail
    function (and none for a flash kernel); chip_smoke's match for kernel
    6's dK/dV kernel picks the wgmma backward and not the dQ kernel."""
    from pytorch_distributed_tpu_torch.tools.profile_train import kind_of

    assert kind_of(kernel) == kind
    tail = {"tail moments": bt.MOMENTS, "tail_bwd_reduce": bt.BWD_REDUCE,
            "tail_bwd_dz": bt.BWD_DZ}.get(kind)
    assert bt.kernel_of(kernel) == tail
    assert chip_smoke.is_dkv_kernel(kernel) == ("flash_bwd_wgmma" in kernel
                                                 or "flash_bwd_kernel" in kernel)
    assert chip_smoke.is_dq_kernel(kernel) == ("flash_bwd_dq" in kernel)


def test_prefill_timing_inputs_and_bound_rehearse_on_cpu(chip_smoke):
    """Phase (d)'s sweep timing at the serve's prefill chunk (B 4 x C 32, W
    64 blocks of 16): the inputs, the library yardstick (SDPA on K/V
    gathered through the tables, with the position mask) agreeing with the
    plain version, and the bound: each visible K/V row read once."""
    from pytorch_distributed_tpu_torch.ops.attention import paged_attention_reference

    inp = chip_smoke.prefill_inputs(torch, torch.float32, dev="cpu")
    q, kp, pos = inp["q"], inp["k_pool"], inp["q_positions"]
    assert tuple(q.shape) == (4, 32, 12, 64) and tuple(kp.shape) == (257, 16, 12, 64)
    assert tuple(inp["block_tables"].shape) == (4, 64)
    assert pos[:, 0].tolist() == [0, 32, 480, 992] and pos[:, -1].tolist() == [31, 63, 511, 1023]
    qg, kg, vg, mask = chip_smoke.gathered(torch, inp)
    sdpa = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    torch.testing.assert_close(sdpa.transpose(1, 2), paged_attention_reference(**inp),
                               rtol=1e-5, atol=1e-5)
    bd = chip_smoke.bound(dict(inp, q=q.bfloat16(), k_pool=kp.bfloat16()))
    visible = 32 + 64 + 512 + 1024  # each batch row's chain up to its last position
    assert bd["bytes"] == (2 * visible * 12 * 64 * 2 + 2 * q.numel() * 2 + pos.numel() * 4
                           + inp["block_tables"].numel() * 4)
    assert bd["flops"] == 4 * 64 * 12 * float((pos + 1).sum())
    assert bd["bound_by"] == "bytes"


def test_gathered_yardstick_repeats_kv_heads_for_gqa(chip_smoke):
    """SDPA's gathered K/V repeat each KV head for its G query heads: at
    H 8, H_kv 2, C 20 (R = 80 rows a KV head) the yardstick is the plain
    version."""
    from pytorch_distributed_tpu_torch.ops.attention import paged_attention_reference

    pos = 150 + np.arange(20)[None, :] + np.array([[0], [40], [7]])
    inp = chip_smoke.decode_inputs(torch, torch.float32, b=3, c=20, h=8, h_kv=2, w=16,
                                   seed=9, positions=pos, dev="cpu")
    qg, kg, vg, mask = chip_smoke.gathered(torch, inp)
    assert tuple(kg.shape) == (3, 8, 256, 64)
    sdpa = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    torch.testing.assert_close(sdpa.transpose(1, 2), paged_attention_reference(**inp),
                               rtol=1e-5, atol=1e-5)


def test_tail_ab_times_the_main_paths_stage_shapes():
    """``tools/tail_ab.py`` times the tail kernels of two checkouts at the
    shapes ``chip_smoke.py`` times them (B 128, E = 4F): all three at
    ResNet-50's four expand-tail shapes, moments also at the four
    downsample inputs, through the three public wrappers."""
    from pytorch_distributed_tpu_torch.tools import tail_ab

    cs = tail_ab._load_chip_smoke(REPO)
    entries = [(label, shape, name) for label, shape, names in cs.tail_shapes()
               for name in names]
    stages = [(f"stage {i + 1}", shape) for i, shape in enumerate(cs.TAIL_STAGES)]
    for name in (bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ):
        assert [(label, shape) for label, shape, n in entries
                if n == name and label.startswith("stage")] == stages
    assert [shape for label, shape, n in entries if label.startswith("downsample")
            and n == bt.MOMENTS] == list(cs.TAIL_DOWNSAMPLE)
    assert len(entries) == 16 and len({(label, n) for label, _, n in entries}) == 16
    assert (tail_ab.THIS / "chip_smoke.py").is_file()


def test_ab_driver_runs_parent_change_change_parent(monkeypatch, capsys, tmp_path):
    """``tail_ab.compare``, the driver of both A/B tools, runs each round
    as parent, change, change, parent, each a worker process of the tool's
    own script on its checkout, and reports each entry's median with the
    card; ``attention_ab`` times kernel 6's split backward and kernel 7's
    sweep through that driver."""
    import json
    import types

    from pytorch_distributed_tpu_torch.tools import attention_ab, tail_ab

    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        if cmd[0] == "nvidia-smi":
            return types.SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")
        root = cmd[cmd.index("--worker") + 1]
        us = 2.0 if root == str(tail_ab.THIS) else 5.0 + len(calls)
        return types.SimpleNamespace(stdout="build noise\n" + json.dumps({"k": us}) + "\n")

    monkeypatch.setattr(tail_ab.subprocess, "run", fake_run)
    summary = tail_ab.compare(attention_ab.__file__, str(tmp_path), rounds=2)
    workers = [c[c.index("--worker") + 1] for c in calls if c[0] != "nvidia-smi"]
    parent, change = str(tmp_path.resolve()), str(tail_ab.THIS)
    assert workers == [parent, change, change, parent] * 2
    assert all(c[1] == attention_ab.__file__ for c in calls if c[0] != "nvidia-smi")
    assert summary["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert summary["median_us"]["change"] == {"k": 2.0}
    assert summary["median_us"]["parent"]["k"] == np.median([5.0 + i for i in (2, 5, 6, 9)])
    assert len(capsys.readouterr().out.strip().splitlines()) == 9



def _small_dp(chip_smoke, monkeypatch):
    monkeypatch.setattr(chip_smoke, "DP", dict(batch=2, steps=3, recipe_batch=2, recipe_steps=2,
                                               timeout_s=120))
    monkeypatch.setattr(chip_smoke, "DP_MODEL", dict(stage_sizes=(1, 1), block="bottleneck",
                                                     num_classes=10, num_filters=8))
    monkeypatch.setattr(chip_smoke, "DP_SIZE", 16)


def test_dp_phase_rehearses_on_cpu(chip_smoke, monkeypatch, tmp_path, capsys):
    """The data-parallel phase end to end with two CPU ranks over gloo at
    a small size (the tiny Bottleneck ResNet, 16^2, B = 2 a rank): the
    five step cases against the emulation or the concatenated batch, the
    fp16 skip, and the three recipes (``--tiny``); no timing on gloo."""
    _small_dp(chip_smoke, monkeypatch)
    out = chip_smoke.dp_runs(torch, "CPU", str(tmp_path), dev="cpu")
    text = capsys.readouterr().out
    assert "backend gloo, 2 ranks on 1 card" in text and "FAIL" not in text
    assert text.count("-staged: not a speed figure") == 5
    assert text.count(" vs the one-process emulation") == 2
    assert text.count("sync-BN fused fp32 vs one rank on the concatenated batch") == 1
    assert text.count("sync-BN plain fp32 vs one rank on the concatenated batch") == 1
    assert text.count("recipes/resnet_") == 3 and "not measured here" in text
    assert out["timing"] is None
    # on the CPU the ranks and the one-process references agree to fp32
    # summation order, far inside the card's tolerances
    for name, errs in out["cases"].items():
        assert max(max(errs["loss"]), max(errs["grad_norm"]), errs["grad_first"],
                   errs["params_first"], errs["buffers_first"], errs["params_last"],
                   errs["buffers_last"]) < 1e-5, name
    # and per-replica statistics sit far from the concatenated batch
    assert out["cases"]["sync-BN plain fp32"]["per_replica_grad_first"] > 0.1
    assert "more than twice the sync-BN tolerance" in text


def test_dp_emulation_tells_per_replica_from_whole_batch_statistics(chip_smoke, monkeypatch):
    """The emulation runs each replica's rows with its own BatchNorm
    statistics: on the same batches it differs from one rank on the whole
    batch by far more than the tolerance it is held to, so the comparison
    would catch ranks that synced their statistics, or swapped rows."""
    from pytorch_distributed_tpu_torch.tools import dp_check

    _small_dp(chip_smoke, monkeypatch)
    spec = dict(chip_smoke.DP_MODEL, dtype="float32")
    batches = dp_check.global_batches(dict(data=dict(n=2, batch=4, size=16, classes=10)))
    two = chip_smoke.emulate_dp(torch, spec, batches, 2, dev="cpu")
    one = chip_smoke.emulate_dp(torch, spec, batches, 1, dev="cpu")
    # interleaved rows (indices[r::2], the sampler the ResNet must not use)
    mixed = [{k: v[[0, 2, 1, 3]] for k, v in b.items()} for b in batches]
    again = chip_smoke.emulate_dp(torch, spec, mixed, 2, dev="cpu")
    tol = chip_smoke.DP_EMULATION_RTOL["float32"]
    for other in (one, again):  # step 0 is where the tight check sits
        for k in ("loss", "grad_norm"):
            assert chip_smoke.rel_err(two[k][0], other[k][0]) > 10 * tol[k][0], k
        for part in ("params", "buffers"):
            err = chip_smoke.state_rel_err(torch, two["first"], other["first"], part == "buffers")
            assert err > 10 * tol[f"{part}_first"], part


def test_dp_device_split_parts_nccl_from_the_other_kernels():
    """``device_split`` over a profiled window: busy is the union of every
    kernel over the wall; NCCL kernels and the rest each as their own
    union a step (overlaps counted once)."""
    from types import SimpleNamespace

    from pytorch_distributed_tpu_torch.tools import dp_check, profile_serve

    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, s, e, kind=cuda):
        return SimpleNamespace(name=name, device_type=kind,
                               time_range=SimpleNamespace(start=s, end=e))

    prof = SimpleNamespace(events=lambda: [
        ev("conv_fwd", 0, 400), ev("bn_fwd", 300, 600), ev("ncclDevKernel_AllReduce", 700, 1000),
        ev("conv_fwd", 1200, 1600), ev("ncclDevKernel_AllReduce", 1700, 2000),
        ev("aten::conv2d", 0, 2000, torch.autograd.DeviceType.CPU)])
    got = dp_check.device_split(prof, 2500.0, 2)
    assert got == {"busy": (600 + 300 + 400 + 300) / 2500, "nccl_ms": 0.3,
                   "compute_ms": 0.5}
    assert profile_serve.busy_share(prof, 2500.0) == got["busy"]


def test_dp_timing_runs_the_counts_and_back(chip_smoke, monkeypatch, tmp_path, capsys):
    """The NCCL timing, with the spawned ranks stood in for: 1, 2, 4 ranks
    and back, each count read twice, the scaling against the mean of the
    two one-card runs, every rank's split printed."""
    from pytorch_distributed_tpu_torch.tools import dp_check

    calls = []

    def fake_run(job, n):
        calls.append(n)

    def fake_load(job, n):
        step = 0.1 + 0.01 * (n - 1) + 0.001 * len(calls)
        return [{name: dict(step_s=[step] * 3, batch=b, busy=0.5, nccl_ms=1.0 * (n > 1),
                            compute_ms=60.0, peak_gib=1.0)
                 for name, b in (("fused bf16", 128), ("plain fp32", 64))} for _ in range(n)]

    monkeypatch.setattr(dp_check, "run", fake_run)
    monkeypatch.setattr(dp_check, "load", fake_load)
    timing = chip_smoke.dp_timing(torch, "CARD", str(tmp_path), 4, dev="cpu")
    assert calls == [1, 2, 4, 4, 2, 1]
    one = timing["fused bf16"][1]
    assert [t["p50_ms"] for t in one] == pytest.approx([101.0, 106.0])
    assert timing["fused bf16"][4][0]["nccl_ms"] == [1.0] * 4
    text = capsys.readouterr().out
    assert text.count("(c) DP timing") == 12 and "second run" in text
    mean_one = np.mean([128 / 0.101, 128 / 0.106])
    assert f"{4 * 128 / 0.133 / mean_one:.3f}x one card" in text


def _small_resume(chip_smoke, monkeypatch):
    monkeypatch.setattr(chip_smoke, "RESUME", dict(
        batch=4, steps=6, suspend_at=3, every=2, nan_at=2, size=16, lm_batch=2, lm_seq=16,
        lm_steps=4, lm_suspend_at=2, dp_batch=2, dp_steps=4, dp_signal=1, timeout_s=120))
    monkeypatch.setattr(chip_smoke, "RESUME_RESNET", dict(
        stage_sizes=(1, 1), block="bottleneck", num_classes=4, num_filters=8,
        dtype="bfloat16", fused=True))
    monkeypatch.setattr(chip_smoke, "RESUME_LM", dict(vocab_size=128, num_layers=2,
                                                      num_heads=2, embed_dim=32))


def test_resume_phase_rehearses_on_cpu(chip_smoke, monkeypatch, tmp_path, capsys):
    """The resume phase end to end at a small size (the tiny fused bf16
    Bottleneck ResNet at 16^2, a 2-layer bf16 LM, 2 gloo ranks): every
    resumed, fallen-back and rolled-back run bitwise equal to its
    reference on the CPU, one rollback, the ranks agreeing on rank 1's
    signal, the save and restore lines; the plain versions launch
    nothing."""
    _small_resume(chip_smoke, monkeypatch)
    out = chip_smoke.resume_runs(torch, "CPU", str(tmp_path), dev="cpu")
    text = capsys.readouterr().out
    assert "FAIL" not in text
    checks = [line for line in text.splitlines() if "max |resumed - uninterrupted|" in line]
    # 5 ResNet checks (suspend, interval saves, fallback, rollback), the LM,
    # the ranks; 3 groups each but the LM's (no BatchNorm) and the counts
    assert len(checks) == 4 * 4 + 3 + 4
    assert all(line.endswith("bitwise") for line in checks)
    assert "1 rollback(s), 2 skipped steps, updates 4 of 6" in text
    assert "the newest truncated: resumed from step-00000004.ckpt" in text
    assert "each rank saved at (epoch, step) [(0, 2), (0, 2)], exit codes [0, 0]" in text
    assert text.count("checkpoint") >= 4 and text.count("; CPU") == 4
    assert out["resnet"]["tail_launches"] == [0, 0, 0] and out["lm"]["flash_launches"] == [0, 0]
    assert out["lm"]["suspend_save"]["bytes"] > out["resnet"]["suspend_save"]["bytes"] > 0
    assert not any((tmp_path / d).exists() for d in ("a1", "a2", "s", "e", "k", "n", "l1", "ls"))


def test_resume_check_fails_a_resume_that_is_not_exact(chip_smoke, capsys):
    failures = []
    chip_smoke.check_resumed(failures, "x", {"params": 0.0, "optimizer": 1e-3},
                             {"params": 1e-7, "optimizer": 1.5e-3})
    chip_smoke.check_resumed(failures, "y", {"params": 1e-3}, {"params": 3e-3})
    assert len(failures) == 2 and "x: params" in failures[0] and "y: params" in failures[1]
    assert capsys.readouterr().out.count("within 2x the repeat") == 1
    assert chip_smoke.leaf_group("state/model/bn_init/running_var") == "bn stats"
    assert chip_smoke.leaf_group("state/optimizer/fc/weight/momentum_buffer") == "optimizer"
    assert chip_smoke.state_diff(torch, {"state/step": 3}, {"state/step": 4}) == {
        "counts": float("inf")}


def _small_data(chip_smoke, monkeypatch):
    from pytorch_distributed_tpu_torch.models.resnet import BasicBlock, ResNet
    from pytorch_distributed_tpu_torch.recipes import common

    monkeypatch.setattr(chip_smoke, "DATA", dict(
        train=16, val=8, size=24, crop=16, batch=4, workers=2, prefetch=2, jpeg=8,
        recipe_batch=2, recipe_steps=2, dp_batch=2, dp_steps=2))
    monkeypatch.setattr(chip_smoke, "DATA_MODEL", dict(
        stage_sizes=(1, 1), block="bottleneck", num_classes=1000, num_filters=8,
        dtype="bfloat16", fused=True))
    # the recipes' ResNet-50 at the tiny width (they run in this process)
    monkeypatch.setattr(common, "build_model", lambda args, classes, precision: ResNet(
        stage_sizes=(1, 1), block_cls=BasicBlock, num_classes=classes, num_filters=8))


@pytest.mark.parametrize("pil", [True, False])
def test_data_phase_rehearses_on_cpu(chip_smoke, monkeypatch, tmp_path, capsys, pil):
    """The data phase end to end at a small size: the raw splits packed,
    every split opened natively, the first native batch bit-equal to the
    per-sample path's, the loader's rates (the JPEG split and rrc only
    where PIL imports), the record-fed fused trainer with every batch from
    the native crop and no loader thread left, both recipes from raw
    splits; the plain versions launch nothing."""
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt
    from pytorch_distributed_tpu_torch.tools import bench_data

    _small_data(chip_smoke, monkeypatch)
    monkeypatch.setattr(bench_data, "have_pil", lambda: pil)
    out = chip_smoke.data_runs(torch, "CPU", str(tmp_path),
                               {"step_s": 0.1, "data_s": 0.01, "net_s": 0.09}, dev="cpu")
    text = capsys.readouterr().out
    assert "FAIL" not in text
    assert "the first batch of the native crop bit-equal to the per-sample path's ok" in text
    assert "native batches 4 train, 2 val" in text and "loader threads alive" in text
    assert text.count("--raw --raw-aug crop on 1 rank(s)") == 2
    assert ("PIL present: the JPEG split and rrc ran" in text) == pil
    rates = {"raw crop, native, 0 workers", "raw crop, native, 2 workers",
             "raw crop, per sample, 0 workers", "raw crop, per sample, 2 workers",
             "raw val center crop, native, 2 workers"}
    if pil:
        rates |= {"jpeg rrc, 2 workers", "raw rrc, 2 workers"}
    assert set(out["rates"]) == rates and all(v > 0 for v in out["rates"].values())
    assert out["tail_launches"] == {bt.MOMENTS: 0, bt.BWD_REDUCE: 0, bt.BWD_DZ: 0}
    assert len(out["losses"]) == 4 and set(out["recipes"]) == {"resnet_single", "resnet_ddp"}
    assert "host " in text and "cores" in text


def test_data_phase_fails_a_split_opened_without_the_native_reader(chip_smoke, monkeypatch,
                                                                   tmp_path):
    from pytorch_distributed_tpu_torch.data import native

    _small_data(chip_smoke, monkeypatch)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(SystemExit, match="without the native reader"):
        chip_smoke.data_runs(torch, "CPU", str(tmp_path), {}, dev="cpu")


def test_data_phase_launch_check_reads_the_counters(chip_smoke):
    """The record-fed run's tail launches against a fake counter: 20 / 16 /
    16 a step over the steps and none in validation."""
    from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

    good = {bt.MOMENTS: 320, bt.BWD_REDUCE: 256, bt.BWD_DZ: 256}
    none = dict.fromkeys(good, 0)
    assert chip_smoke.launch_problems(good, none, 16, (20, 16, 16)) == []
    wrong = chip_smoke.launch_problems(dict(good, **{bt.BWD_DZ: 255}), none, 16, (20, 16, 16))
    assert len(wrong) == 1 and "tail_bwd_dz: 255 launches in 16 steps, want 256" in wrong[0]
    wrong = chip_smoke.launch_problems(good, dict(none, **{bt.MOMENTS: 1}), 16, (20, 16, 16))
    assert wrong == [f"validation launched tail kernels: {dict(none, **{bt.MOMENTS: 1})}"]
    assert chip_smoke.launch_problems(none, none, 16, (0, 0, 0)) == []
