"""``chip_smoke.py``'s graph step (phase (c): the serve's CUDA graphs)
rehearsed on the CPU, in a file of its own so that the test workers share
the rehearsals out. Torch runs one thread here: the workers share the
machine's cores, and eight threads a worker made this rehearsal some 40
times slower."""

import concurrent.futures
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


def test_graph_phase_rehearses_on_cpu(chip_smoke, monkeypatch, capsys):
    """Phase (c)'s graph step at a small size on the CPU (no graphs there:
    both paths run the static-buffer programs eagerly): the warmed-up
    serves of both paths agree, the warmup prepares every reachable
    program, the sampled serve's two decode ticks draw differently and
    the sampler draws as ``torch.multinomial``."""
    from pytorch_distributed_tpu_torch.compilecache import serving_registry
    from pytorch_distributed_tpu_torch.models import init_params, params_from_jax, tiny_config
    from pytorch_distributed_tpu_torch.serving import Scheduler

    cfg = tiny_config(max_seq_len=64)
    state = params_from_jax(init_params(cfg, 0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 25, size=4)]
    serve_kw = dict(n_slots=3, block_len=8, prefill_chunk=8, device="cpu")
    served = []

    def serve(label, reqs, *, warm=False, **kw):
        sched = Scheduler(cfg, state, gather_impl="kernel", **{**serve_kw, **kw})
        if warm:
            sched.warmup(background=False)
        rids = [sched.submit(p, 32) for p in reqs]
        out = sched.drain()
        m = sched.metrics()
        serving_registry(sched.engine).assert_covers(sched.engine.compiled_program_names())
        served.append((label, m["cold_requests"]))
        return sched, [out[r] for r in rids], m, 1.0, {}

    def busy(cfg_, prompts_, max_new, kws_by_path, weights):
        assert max_new == 32 and weights == "lm.pt" and list(kws_by_path) == [
            "eager", "graphs", "lagged", "fleet_sync", "fleet_async"]
        assert [[kw.get("cuda_graphs", True) for kw in kws]
                for kws in kws_by_path.values()] == [
            [False, False], [True, True], [True], [True], [True]]
        assert kws_by_path["lagged"][0]["lagged"]
        assert [kws_by_path[p][0]["fleet"] for p in ("fleet_sync", "fleet_async")] == [
            dict(n_replicas=2, async_host=False), dict(n_replicas=2, async_host=True)]
        return {path: [0.5] * len(kws) for path, kws in kws_by_path.items()}

    monkeypatch.setattr(chip_smoke, "busy_shares", busy)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    out = chip_smoke.graph_runs(torch, "CPU", serve, cfg, state, prompts, serve_kw,
                                n_blocks=40, weights="lm.pt", dev="cpu")
    text = capsys.readouterr().out
    assert [label for label, _ in served] == [
        "bf16 pools, eager, warmed up", "bf16 pools, graphs, warmed up",
        "fp8 pools, eager, warmed up", "fp8 pools, graphs, warmed up",
        "bf16 pools, temperature 0.8, top-k 50, seed 7, warmed up"]
    assert all(cold == 0 for _, cold in served)
    assert text.count("eager vs CUDA graphs (both warmed up)") == 2
    assert out["bf16"]["eager_busy"] == out["fp8"]["graphs_busy"] == 0.5
    assert out["bf16"]["lagged_busy"] == 0.5
    assert out["fleet_busy"] == {"fleet_sync": 0.5, "fleet_async": 0.5}
    assert out["warmup"]["programs"] == 13 and out["warmup"]["graphs"] == 0
    assert out["sampled"]["tokens"] == 4 * 32 and "sampled serve" in text


def test_busy_shares_profile_eager_apart_and_the_graph_paths_together(chip_smoke,
                                                                       monkeypatch):
    """The profiled serves take a process for each path kept apart (the
    eager one, the lagged fleet), then one for every other graph path in
    the order given; each path's shares come back under its name, in the
    caller's order."""
    groups = []

    class InOrder:  # each submit a process of its own, run here
        def __init__(self, **kw):
            assert kw["max_workers"] == 1 and kw["max_tasks_per_child"] == 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def submit(self, fn, cfg, prompts, max_new, kws_by_path, weights):
            assert fn is chip_smoke._busy_child and weights == "lm.pt"
            groups.append(list(kws_by_path))
            done = concurrent.futures.Future()
            done.set_result({p: [len(groups)] * len(k) for p, k in kws_by_path.items()})
            return done

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor", InOrder)
    kws = {"graphs": [{}, {}], "eager": [{}, {}], "lagged": [{}], "fleet_sync": [{}],
           "fleet_async": [{}]}
    out = chip_smoke.busy_shares(None, [], 32, kws, "lm.pt")
    assert groups == [["eager"], ["fleet_async"], ["graphs", "lagged", "fleet_sync"]]
    assert list(out) == list(kws)
    assert out == {"graphs": [3, 3], "eager": [1, 1], "lagged": [3], "fleet_sync": [3],
                   "fleet_async": [2]}
