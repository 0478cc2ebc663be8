"""``chip_smoke.py``'s tensor-parallel phase rehearsed on the CPU.

The phase end to end with two CPU ranks over gloo at a small size (2
layers, 4 heads of 32, vocab 128, L = 32, B = 2, 3 steps): T 2 with MHA,
with vocab parallelism and with GQA + RoPE (K/V heads 4) against the
one-device step from the same weights (losses, grad norms, every
parameter's update, the validation loss), the state shares against the
parameter counts' prediction, the launch counters (none: CPU tensors run
the plain versions), and ``lm_pretrain --model-parallel 2`` against its
one-device run.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_tp_phase_rehearses_on_cpu(chip_smoke, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(chip_smoke, "RING_MODEL", dict(vocab_size=128, num_layers=2,
                                                       num_heads=4, embed_dim=128))
    monkeypatch.setattr(chip_smoke, "TP", dict(chip_smoke.TP, batch=2, seq=32, timeout_s=120))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.tp_runs(torch, "CPU", str(tmp_path), dev="cpu")
    finally:
        torch.set_num_threads(threads)
    text = capsys.readouterr().out
    assert "backend gloo, 2 ranks on 1 card" in text and "FAIL" not in text, text
    for case in ("mha", "vocab", "gqa"):
        assert f"LM TP t2 {case} vs the one-card step" in text
        assert f"LM TP t2 {case}: every parameter gathered to its global leaf" in text
    assert "recipes/lm_pretrain.py --model-parallel 2: validation loss" in text
    assert all(v == 0 for v in out["flash_launches"].values())  # plain versions
    # bf16 on the CPU too: TP's other roundings, inside the card's limits
    for errs in out["errs"].values():
        assert max(errs["loss"]) <= chip_smoke.TP_RTOL["loss"][-1], errs
        assert errs["update"] <= chip_smoke.TP_UPDATE_RTOL["worst"], errs
    assert set(out["state_share"]) == {"t2 mha", "t2 vocab", "t2 gqa"}


def test_tp_phase_four_rank_grids_rehearse_on_cpu(chip_smoke, monkeypatch, tmp_path, capsys):
    """The 4-card grids on four gloo ranks: T 2 x DP 2 (also vocab-parallel
    and with FSDP), T 4 (also vocab-parallel) and replicated DP 4 against
    the one-device step, state shares, step p50 against DP 4's."""
    monkeypatch.setattr(chip_smoke, "RING_MODEL", dict(vocab_size=128, num_layers=2,
                                                       num_heads=4, embed_dim=128))
    monkeypatch.setattr(chip_smoke, "TP", dict(chip_smoke.TP, batch_4=4, seq=32, timeout_s=120))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.tp_runs(torch, "CPU", str(tmp_path), dev="cpu", recipes=False,
                                 cpu_ranks=4)
    finally:
        torch.set_num_threads(threads)
    text = capsys.readouterr().out
    assert "FAIL" not in text, text
    assert set(out["step_p50"]) == {"t2 x dp2 mha", "t2 x dp2 vocab", "t2 x dp2 fsdp",
                                    "t4 mha", "t4 vocab", "dp4 replicated"}
    assert "step p50 over 4 gloo ranks" in text
    # FSDP over the data pair on top of T 2: below T 2 alone
    assert out["state_share"]["t2 x dp2 fsdp"] < out["state_share"]["t2 x dp2 mha"]


@pytest.mark.parametrize("t,vocab,want", [(2, False, 0.687), (2, True, 0.506),
                                          (4, False, 0.530), (4, True, 0.259)])
def test_predicted_state_share_at_full_width(chip_smoke, t, vocab, want):
    model = chip_smoke.tp_model(t, vocab_parallel=vocab)
    assert abs(chip_smoke.predicted_share(torch, model) - want) < 5e-4
