"""``chip_smoke.py``'s fleet phase rehearsed on the CPU.

``fleet_runs`` at the serving geometry (8 slots a replica, blocks of 16,
chunk 32, 2048 positions, so the seeded trace spills and sheds as on the
card) on a one-layer model 32 wide, with the plain versions in place of
the kernels: both loops, the disaggregated fleet on float and fp8 pools,
the trace, the failure plane, the gateway and the two ``serve_lm``
processes (``--device cpu --tiny``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # a CPU tick is slower than the card's: a longer deadline, a longer hang
    monkeypatch.setattr(cs, "FLEET_HANG", dict(tick_deadline_s=2.0, seconds=2.5))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cs
    torch.set_num_threads(threads)


def test_fleet_phase_rehearses_on_cpu(chip_smoke, capsys):
    from pytorch_distributed_tpu_torch.models import init_params, params_from_jax
    from pytorch_distributed_tpu_torch.recipes.serve_lm import full_config

    cfg = full_config(num_layers=1, embed_dim=32, num_heads=2, vocab_size=512,
                      dtype=torch.float32)
    state = params_from_jax(init_params(cfg, 0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 400, size=12)]
    serve_kw = dict(n_slots=8, block_len=16, prefill_chunk=32, device="cpu")
    tiny = ["--device", "cpu", "--tiny", "--replicas", "2"]
    recipes = {"disaggregated": [*tiny, "--disaggregate", "--async-host", "--requests", "4",
                                 "--max-new", "3"],
               "gateway": [*tiny, "--http-port", "0", "--http-duration", "3"]}
    out = chip_smoke.fleet_runs(torch, "CPU", cfg, state, prompts, serve_kw, kill_tick=6,
                                recipes=recipes, dev="cpu")
    text = capsys.readouterr().out
    assert out["loops"]["async_syncs_per_step"] == [0, 0]
    assert out["disagg"]["handoffs"] == len(prompts) and out["disagg"]["same_buckets"]
    assert out["trace"]["spilled"] >= 1 and out["trace"]["shed"] >= 1
    assert out["trace"]["submitted"] == chip_smoke.FLEET_TRACE_N
    assert out["faults"]["moved"] and out["faults"]["revive_captured"] == (0, 0)
    assert {r["exit"] for r in out["recipes"].values()} == {0}
    assert out["recipes"]["disaggregated"]["handoffs"] == 4
    assert text.count(f"{len(prompts)} of {len(prompts)} byte-equal") == 2
    assert "its gateway answered complete" in text
    assert out["loops"]["one_busy_events"] == [None, None]  # no events on the CPU
    busy = {"one_step": 0.5, "one_lagged": 0.5, "fleet_sync": 0.6, "fleet_async": 0.7}
    line = chip_smoke.fleet_line("CPU", out, busy)
    assert ("busy by CUDA events not measured, not measured / not measured, not measured / "
            "not measured, not measured") in line
    assert "one replica 0.500 (lagged 0.500), fleet 0.600 / 0.700" in line
