"""``chip_smoke.py``'s tensor-parallel serve rehearsed on the CPU.

The TP phase's serve cases (``tp_serve_job``) on its spawn of two CPU
ranks over gloo, without its training cases, at a small size (2 layers, 4
heads of 32, vocab 128, 128 positions, prompts of 12-56 tokens, 6 new):
bf16 pools, fp8 pools, GQA + RoPE (2 KV heads, one a rank) with the
prefix cache (hits), and vocab parallelism, each against the one-card
replicated serve rank 0 runs (the logits within the phase's limits,
``TP_SERVE_TOL``), the ranks' streams and logits rows bit-equal, a rank's
pool exactly half the replicated pool's bytes, and the launch counters
(none: CPU tensors run the plain versions).
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


def small(chip_smoke, monkeypatch):
    monkeypatch.setattr(chip_smoke, "RING_MODEL", dict(vocab_size=128, num_layers=2,
                                                       num_heads=4, embed_dim=128))
    monkeypatch.setattr(chip_smoke, "TP", dict(chip_smoke.TP, timeout_s=120))
    monkeypatch.setattr(chip_smoke, "TP_SERVE", dict(
        chip_smoke.TP_SERVE, lengths=(40, 12, 56, 24), prefix=32, chunk=16, stagger=3,
        max_new=6, max_seq_len=128))
    gqa = dict(num_kv_heads=2, pos_embedding="rope")
    monkeypatch.setitem(chip_smoke.TP_SERVE_CASES, "gqa_prefix", (gqa, {"prefix_cache": True}))


def test_tp_serve_rehearses_on_cpu(chip_smoke, monkeypatch, tmp_path, capsys):
    small(chip_smoke, monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.tp_runs(torch, "CPU", str(tmp_path), dev="cpu", serve=True,
                                 train=False)
    finally:
        torch.set_num_threads(threads)
    text = capsys.readouterr().out
    assert "FAIL" not in text, text
    assert set(out["serve"]) == set(chip_smoke.TP_SERVE_CASES)
    for case, got in out["serve"].items():
        assert f"LM TP serve t2 {case}" in text
        assert got["pool_share"] == 0.5
        assert got["first"] <= chip_smoke.TP_SERVE_TOL["first"]
        assert got["rows"] <= chip_smoke.TP_SERVE_TOL["rows"]
    assert "ranks' streams and logits rows bit-equal True" in text
    assert "prefix hits" in text
    assert all(v == 0 for v in out["serve_launches"].values())  # plain versions


def test_tp_serve_prompts_share_a_block_aligned_prefix(chip_smoke):
    prompts = chip_smoke.tp_serve_prompts()
    p = chip_smoke.TP_SERVE["prefix"]
    assert p % chip_smoke.TP_SERVE["block_len"] == 0
    assert (prompts[2][:p] == prompts[0][:p]).all()
    assert [len(x) for x in prompts] == list(chip_smoke.TP_SERVE["lengths"])
    assert min(map(len, prompts)) >= 64 and max(map(len, prompts)) <= 512


def test_tp_serve_pool_share_at_full_width(chip_smoke):
    """A rank's pool at T 2 is half the replicated pool: a block of 16 at
    full width is 589,824 bytes, 294,912 a rank (PERF.md's prediction)."""
    from pytorch_distributed_tpu_torch.serving.kv_pool import pool_block_bytes
    from pytorch_distributed_tpu_torch.tools.ring_check import _model_config
    from pytorch_distributed_tpu_torch.tools.serve_tp import replicated

    model = chip_smoke.tp_serve_model()
    assert pool_block_bytes(_model_config(replicated(model)), 16) == 589_824
    assert pool_block_bytes(_model_config(model), 16) == 294_912
    four = dict(model, tp_size=4)
    assert pool_block_bytes(_model_config(four), 16) == 147_456
