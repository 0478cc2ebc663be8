"""The slice as a whole: sequence-parallel LM training against the JAX
package's.

Three steps of the tiny fp32 config on a data x seq grid of ranks (1 x 2
and 2 x 2, contiguous and zigzag), spawned over gloo with a ``file://``
rendezvous under the test's temporary directory, with the port's ring over
the flash kernels' plain versions (``attention="ring_flash"``, the
recipe's default) and its plain ring (``"ring"``), against JAX
``make_lm_train_step`` over the same mesh on the virtual CPU devices with
``attention="ring"``, from the same weights (``params_from_jax``) on the
same batches. Each grid is one spawn, which trains every config.

Tolerances are ``test_torch_lm_train.py``'s: losses and grad norms to 1e-5
relative each step, parameters to 2e-5 after three (the key bias, whose
gradient is rounding noise, to 3 lr).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.optim import build_optimizer as jax_build_optimizer
from pytorch_distributed_tpu.ops.schedules import warmup_cosine as jax_warmup_cosine
from pytorch_distributed_tpu.parallel.sequence import zigzag_shard as jax_zigzag_shard
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu_torch.models import params_from_jax, params_to_jax, tiny_config
from pytorch_distributed_tpu_torch.tools import ring_check
from pytorch_distributed_tpu_torch.train import lm_collate

SEQ = 32
SCHED = (1e-2, 6, 1, 1e-3)
GRIDS = {"dp1xsp2": (1, 2), "dp2xsp2": (2, 2)}
RUNS = [(attn, layout) for attn in ("ring_flash", "ring") for layout in ("contiguous", "zigzag")]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def batches(dp):
    rng = np.random.default_rng(7)
    return [lm_collate(list(rng.integers(1, 128, (2 * dp, SEQ)).astype(np.int32)))
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def jax_initial_state():
    jcfg = jax_tiny_config(attention="ring", max_seq_len=SEQ)
    tx = jax_build_optimizer("adamw", jax_warmup_cosine(*SCHED), weight_decay=0.1)
    state = jax_lm.create_lm_state(jcfg, tx, jax.random.key(0), init_len=SEQ)
    return jax.tree.map(np.asarray, state.params)


@functools.lru_cache(maxsize=None)
def jax_run(dp: int, sp: int, layout: str):
    """Metrics of each step and the final parameters of the JAX step."""
    jcfg = jax_tiny_config(attention="ring", max_seq_len=SEQ, ring_layout=layout)
    tx = jax_build_optimizer("adamw", jax_warmup_cosine(*SCHED), weight_decay=0.1)
    state = jax_lm.create_lm_state(jcfg, tx, jax.random.key(0), init_len=SEQ)
    mesh = Mesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp), ("data", "seq"))
    step = jax_lm.make_lm_train_step(mesh, config=jcfg, grad_clip_norm=1.0)
    metrics = []
    for batch in batches(dp):
        if layout == "zigzag":
            batch = {k: jax_zigzag_shard(v, sp) for k, v in batch.items()}
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.array, state.params)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    params = params_from_jax(jax_initial_state())
    out = {}
    for grid, (dp, sp) in GRIDS.items():
        tmp = tmp_path_factory.mktemp(grid)
        models = {f"{a}/{lay}": dict(vocab_size=128, num_layers=2, num_heads=2,
                                     embed_dim=32, max_seq_len=SEQ, dtype="float32",
                                     attention=a, ring_layout=lay) for a, lay in RUNS}
        job = dict(task="train", backend="gloo", rendezvous=f"file://{tmp}/rendezvous",
                   out=str(tmp / "out"), dp=dp, sp=sp, device="cpu", models=models,
                   params=params, batches=batches(dp), schedule=SCHED, weight_decay=0.1,
                   grad_clip_norm=1.0, timeout_s=120)
        ring_check.run(job, dp * sp)
        out[grid] = ring_check.load(job)
    return out


@pytest.mark.parametrize("attention,layout", RUNS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_three_ring_train_steps_match_jax(port_runs, grid, attention, layout):
    dp, sp = GRIDS[grid]
    results = port_runs[grid]
    name = f"{attention}/{layout}"
    want_metrics, want_params = jax_run(dp, sp, layout)
    for r in results:  # every rank reports the same all-reduced metrics
        m = r[name]["metrics"]
        assert r[name]["step"] == 3
        for i, jm in enumerate(want_metrics):
            np.testing.assert_allclose(m["loss"][i], jm["loss"], rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"][i], jm["grad_norm"], rtol=1e-5)
            assert m["tokens"][i] == jm["tokens"]
    got = params_to_jax(results[0][name]["params"], tiny_config(max_seq_len=SEQ))
    want = {k: dict(v) if isinstance(v, dict) else v for k, v in want_params.items()}
    for i in range(2):
        k_got, k_want = (p[f"block{i}"]["attn"]["qkv"]["bias"][1] for p in (got, want))
        np.testing.assert_allclose(k_got, k_want, rtol=0, atol=3 * SCHED[0])
        for p in (got, want):
            p[f"block{i}"]["attn"]["qkv"]["bias"][1] = 0.0
    fa, ta = jax.tree_util.tree_flatten(got)
    fb, tb = jax.tree_util.tree_flatten(want)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-4, atol=2e-5)


def test_seq_parallel_recipe_runs_on_the_cpu(tmp_path):
    """``python -m ...lm_pretrain --device cpu --tiny --seq-parallel 2``:
    two gloo ranks train the tiny model for two epochs and validate."""
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_IP", "MASTER_PORT")}
    r = subprocess.run([sys.executable, "-m", "pytorch_distributed_tpu_torch.recipes.lm_pretrain",
                        "--device", "cpu", "--tiny", "--seq-parallel", "2",
                        "--save-dir", str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "attention ring_flash, grid 1 x 2" in r.stdout
    assert '"best_ppl"' in r.stdout.splitlines()[-1]


def test_seq_sharded_mesh_needs_ring_attention():
    from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup, Mesh as PortMesh
    from pytorch_distributed_tpu_torch.train import make_lm_train_step

    mesh = PortMesh(AxisGroup(None, 1, 0), AxisGroup(None, 2, 0))
    with pytest.raises(ValueError, match="non-ring attention is shard-local"):
        make_lm_train_step(mesh=mesh, config=tiny_config(attention="flash"))
    make_lm_train_step(mesh=mesh, config=tiny_config(attention="ring_flash"))


def test_seq_parallel_recipe_refuses_more_ranks_than_cards(monkeypatch):
    """On CUDA each rank needs its own card (NCCL): a sequence group larger
    than the visible cards, or one that does not divide them, is refused
    before anything is spawned or built."""
    from pytorch_distributed_tpu_torch.recipes import lm_pretrain

    monkeypatch.delenv("MASTER_IP", raising=False)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs a card per rank"):
        lm_pretrain.main(["--tiny", "--seq-parallel", "2"])
    monkeypatch.setattr("torch.cuda.device_count", lambda: 3)
    with pytest.raises(SystemExit, match="do not split into sequence groups of 2"):
        lm_pretrain.main(["--tiny", "--seq-parallel", "2"])


@pytest.mark.parametrize("device, cards, nodes, sp, want", [
    ("cpu", 0, 1, 2, (1, 2)),  # one replica of sp gloo ranks
    ("cpu", 0, 2, 4, (1, 2)),
    (None, 1, 1, 1, (1, 1)),  # one card: the single-process path
    (None, 0, 1, 1, (1, 1)),  # no card: the single-process path raises
    (None, 4, 1, 2, (2, 4)),  # as JAX: dp = cards // sp
    (None, 4, 1, 1, (4, 4)),
    (None, 4, 2, 4, (2, 4)),  # 8 cards on 2 nodes, 4 ranks spawned on each
])
def test_recipe_grid_factors_the_cards_as_jax(monkeypatch, device, cards, nodes, sp, want):
    """``(dp, ranks on this node)``: the JAX recipe's dp = devices // sp
    over every node's cards on CUDA, dp 1 on the CPU."""
    from pytorch_distributed_tpu_torch.recipes import lm_pretrain

    monkeypatch.setattr("torch.cuda.device_count", lambda: cards)
    if nodes > 1:
        monkeypatch.setenv("MASTER_IP", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "29500")
        monkeypatch.setenv("WORLD_SIZE", str(nodes))
    else:
        monkeypatch.delenv("MASTER_IP", raising=False)
    argv = ["--tiny", "--seq-parallel", str(sp)] + (["--device", device] if device else [])
    assert lm_pretrain.grid(lm_pretrain._parse(argv)) == want


def test_ring_config_follows_jax_validation():
    """``ring_layout`` as the JAX config checks it, and a zigzag forward
    without its position vector raises as the JAX module does."""
    import torch

    from pytorch_distributed_tpu_torch.models import TransformerLM

    with pytest.raises(ValueError, match="must be 'contiguous' or 'zigzag'"):
        tiny_config(attention="ring", ring_layout="spiral")
    with pytest.raises(ValueError, match="only applies to ring attention"):
        tiny_config(attention="flash", ring_layout="zigzag")
    for attention in ("ring", "ring_flash"):
        model = TransformerLM(tiny_config(attention=attention, ring_layout="zigzag"))
        with pytest.raises(ValueError, match="requires the per-shard position vector"):
            model(torch.zeros(1, 8, dtype=torch.long))
    from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM

    with pytest.raises(ValueError, match="requires the per-shard position vector"):
        JaxLM(jax_tiny_config(attention="ring", ring_layout="zigzag")).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
