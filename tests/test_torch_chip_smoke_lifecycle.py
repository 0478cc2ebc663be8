"""``chip_smoke.py``'s lifecycle step (phase (c): the request lifecycle and
the dense decode path) rehearsed on the CPU, in a file of its own so that
the test workers share the rehearsals out. Torch runs one thread here: the
workers share the machine's cores, and eight threads a worker made this
rehearsal some 40 times slower."""

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


def test_lifecycle_phase_rehearses_on_cpu(chip_smoke, capsys):
    """Phase (c)'s lifecycle step at a small size on the CPU: the lagged
    loop's serves equal ``step()``'s, the pressure serve under a fault at
    every ``kv.*`` site keeps its streams, the scripted cancels and
    deadlines act on the same requests in both loops and leave nothing
    behind, the drain and the abandon free every block, the dense batcher
    agrees with the paged one and both with the full forward, the planted
    fault shows in the retried request alone, and ``serve_lm --dense``
    runs."""
    from pytorch_distributed_tpu_torch.models import init_params, params_from_jax, tiny_config
    from pytorch_distributed_tpu_torch.serving import Scheduler

    cfg = tiny_config(max_seq_len=128)
    state = params_from_jax(init_params(cfg, 0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 80, size=10)]
    serve_kw = dict(n_slots=4, block_len=8, prefill_chunk=8, device="cpu")
    served = []

    def serve(label, reqs, *, warm=False, lagged=False, hook=None, **kw):
        sched = Scheduler(cfg, state, gather_impl="kernel", **{**serve_kw, **kw})
        if warm:
            sched.warmup(background=False)
        if hook is not None:
            hook(sched)
        rids = [sched.submit(p, 32) for p in reqs]
        out = chip_smoke.lagged_drain(sched) if lagged else sched.drain()
        assert sched.engine.allocator.in_use == 0 and not sched.has_uncollected
        served.append(label)
        return sched, [out[r] for r in rids], sched.metrics(), 1.0, {}

    pressure_kw = dict(kv_dtype="fp8", n_blocks=30, offload=True, preempt_on_oom=True,
                       swap_policy="swap")
    _, streams, m, _, _ = serve("pressure", prompts, **pressure_kw)
    assert m["preempts"] >= 1
    out = chip_smoke.lifecycle_runs(
        torch, "CPU", serve, cfg, state, prompts, serve_kw, pressure_kw=pressure_kw,
        pressure_streams=streams, busy={"graphs_busy": 0.5, "lagged_busy": 0.5},
        recipe_argv=["--dense", "--device", "cpu", "--tiny", "--requests", "3",
                     "--max-new", "3"], dev="cpu")
    text = capsys.readouterr().out
    assert served[1:] == ["bf16 pools, graphs, step loop, warmed up",
                          "bf16 pools, graphs, lagged loop, warmed up",
                          "pressure, fp8 pools, swap, lagged loop",
                          "pressure, fp8 pools, swap, a fault at each kv.* site, step loop",
                          "pressure, fp8 pools, swap, a fault at each kv.* site, lagged loop",
                          "pressure, fp8 pools, swap, a fault at each kv.* site, planted loop"]
    assert out["faults"]["swap_aborts"] >= 3 and out["faults"]["streams_equal"]
    assert out["faults"]["differ"] == [] and len(out["faults"]["planted_differ"]) == 1
    assert set(out["faults"]["faulted"]) <= set(out["faults"]["same_buckets"])
    assert out["ragged_fp32"]["drawn"] and out["ragged_fp32"]["equal_to_generate"]
    assert max(out["batcher"]["dense_max_abs_err"], out["batcher"]["paged_max_abs_err"]) < 1e-4
    assert out["faults"]["exact"] == dict.fromkeys(
        ("kv.swap_out_d2h", "kv.host_write", "kv.swap_in_h2d"), True)
    assert out["loops"]["lagged_busy"] == 0.5
    assert out["batcher"]["greedy_match"] == 1.0 and out["ragged_match"] == 1.0
    assert out["recipe"]["tokens_out"] == 9
    assert text.count("blocks in use, host chains, live table entries after: (0, 0, 0)") == 4
    assert "requeued exactly them True" in text and "the next submit refused True" in text
