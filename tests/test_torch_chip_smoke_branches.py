"""``chip_smoke.py``'s model-branches step (phase (c): the GQA + RoPE LM
served (each drawn decode row against the full forward), decoded densely
and trained, dropout, MoE (a layer against the one-hot spelling),
blockwise and the recipe) rehearsed on the CPU at a small size: the
full-width config is replaced by a narrow one of the same geometry (G =
3), the serve by a plain ``Scheduler`` drain, and the kernels run their
plain versions (so no launch is counted). Torch runs one thread here, as
in the other rehearsals."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cs
    torch.set_num_threads(threads)


def test_branches_phase_rehearses_on_cpu(chip_smoke, monkeypatch, tmp_path, capsys):
    from pytorch_distributed_tpu_torch.models import tiny_config
    from pytorch_distributed_tpu_torch.ops import paged_flash
    from pytorch_distributed_tpu_torch.recipes import serve_lm
    from pytorch_distributed_tpu_torch.serving import Scheduler

    def narrow(**overrides):  # 6 heads over 2 KV heads: G = 3, as H 12 over 4
        return tiny_config(**{**dict(num_heads=6, embed_dim=48, max_seq_len=128), **overrides})

    monkeypatch.setattr(serve_lm, "full_config", narrow)
    monkeypatch.setattr(chip_smoke, "BRANCH_MODEL", dict(num_kv_heads=2, pos_embedding="rope"))
    monkeypatch.setattr(chip_smoke, "TRAIN", dict(batch=2, seq=32, steps=3))
    monkeypatch.setattr(chip_smoke, "BRANCH", dict(chip_smoke.BRANCH, dropout_steps=4,
                                                   suspend_at=2, moe_steps=2))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 60, size=6)]
    serve_kw = dict(n_slots=3, block_len=8, prefill_chunk=8, device="cpu")
    served = []

    def serve(label, reqs, *, warm=False, model=None, **kw):
        sched = Scheduler(*model, gather_impl="kernel", **{**serve_kw, **kw})
        if warm:
            sched.warmup(background=False)
        rids = [sched.submit(p, 32) for p in reqs]
        out = sched.drain()
        assert sched.engine.allocator.in_use == 0
        served.append(label)
        return sched, [out[r] for r in rids], sched.metrics(), 1.0, {}

    def per_tick(engine):
        return {paged_flash.SPLIT: 2, paged_flash.variant(paged_flash.SPLIT,
                                                          engine.cache[0].key.dtype)
                if engine.cache[0].key_scale is not None else paged_flash.SPLIT: 2}

    warm = {"graphs_tick_p50_s": 0.001, "graphs_tok_per_s": 1.0, "graphs_ttft_p50_s": 0.01}
    out = chip_smoke.branches_runs(
        torch, "CPU", serve, per_tick,
        {"launches": {}, "warm_bf16": warm, "warm_fp8": warm, "step_s": 0.1}, prompts,
        serve_kw, str(tmp_path),
        ["--device", "cpu", "--synthetic", "--layers", "1", "--heads", "6", "--kv-heads", "2",
         "--embed-dim", "48", "--vocab-size", "128", "--seq-len", "32", "--batch-size", "2",
         "--pos-embedding", "rope", "--dropout", "0.1", "--steps", "2"], dev="cpu")
    text = capsys.readouterr().out
    assert served == ["GQA + RoPE (H 12 over H_kv 4), bf16 pools, warmed up",
                      "GQA + RoPE (H 12 over H_kv 4), fp8 pools, warmed up"]
    assert out["serve"]["bf16"]["pool_bytes"] * 3 == out["serve"]["bf16"]["mha_pool_bytes"]
    assert out["serve"]["fp8"]["pool_bytes"] * 3 == out["serve"]["fp8"]["mha_pool_bytes"]
    assert out["serve"]["dense_match"] == 1.0 and out["serve"]["prefill_max_abs_err"] < 1e-4
    assert out["serve"]["bf16"]["drawn_rows"] == len(prompts) * 31
    assert out["serve"]["bf16"]["drawn_rows_max_abs_err"] < 1e-4
    assert out["dense_decode"]["drawn"] and out["dense_decode"]["equal_to_generate"]
    assert len(out["train"]["losses"]) == 3 and all(np.isfinite(out["train"]["losses"]))
    assert set(out["first_step"]) == {"flash", "blockwise", "dense"}
    assert not any(out["dropout"]["repeat"].values())
    assert "dropout suspend at step 2 / resume: params" in text and "FAIL" not in text
    for top in ("top1", "top2"):
        assert len(out["moe"][top]["dropped"]) == 2
        one_hot = out["moe"][top]["one_hot"]
        assert one_hot["same_routes"] and one_hot["max_abs_err"] <= one_hot["tol"]
        assert one_hot["tokens"] == 2 * 32 and one_hot["dropped"] == one_hot["dropped_plain"]
    assert out["recipe"]["exit"] == 0 and np.isfinite(out["recipe"]["loss"])
