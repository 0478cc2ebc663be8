"""``chip_smoke.py``'s bottleneck-tail phases rehearsed on the CPU.

The script runs only on the card, so its control flow is checked here at
small shapes: the kernel checks of phase (b) and the timings of phase (d)
run against the plain versions (``dev="cpu"``), with the card's timer
replaced; the bounds are checked against the shapes' arithmetic.
"""

import importlib.util
from pathlib import Path

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
    return cs


def test_tail_checks_and_timings_rehearse_on_cpu(chip_smoke, capsys):
    failures = []
    errs = chip_smoke.check_tail_kernels(torch, failures, dev="cpu")
    assert failures == []
    assert set(errs) == {bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ}
    out = capsys.readouterr().out
    assert out.count("bit-equal") == 12  # 4 stages x 2 dtypes + 2 ragged x 2 dtypes
    assert "FAIL" not in out
    entries = chip_smoke.time_tail_kernels(torch, "CPU", dev="cpu")
    assert set(entries) == {bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ}
    for entry in entries.values():
        assert set(entry) == {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "spelling_ms"}
        assert entry["library_ms"] is None and entry["bound_ms"] > 0


def test_tail_bounds_at_resnet50_stage_shapes(chip_smoke):
    """Stage 1 (z [401408, 64], E 256) is bound by bytes, stage 4's moments
    and tail_bwd_dz (z [6272, 512], E 2048) by bf16 operations."""
    bf16 = torch.bfloat16
    s1 = {k: chip_smoke.tail_bound(k, 401408, 64, 256, 2, bf16)
          for k in (bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ)}
    assert s1[bt.MOMENTS]["bytes"] == 401408 * 64 * 2 + (64 + 64 * 64) * 4
    assert s1[bt.BWD_REDUCE]["bytes"] == 401408 * (64 + 3 * 256) * 2 + (64 * 256 + 256) * 4
    assert s1[bt.BWD_DZ]["flops"] == 2 * 401408 * 320 * 64
    assert all(v["bound_by"] == "bytes" for v in s1.values())
    assert s1[bt.BWD_REDUCE]["bound_ms"] == pytest.approx(0.1994, rel=1e-3)
    s4 = {k: chip_smoke.tail_bound(k, 6272, 512, 2048, 2, bf16)
          for k in (bt.MOMENTS, bt.BWD_DZ)}
    assert all(v["bound_by"] == "operations" for v in s4.values())
    assert s4[bt.BWD_DZ]["bound_ms"] == pytest.approx(2 * 6272 * 2560 * 512 / 989e12 * 1e3)
