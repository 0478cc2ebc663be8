"""Megatron vocab parallelism in the port against the JAX package's
(``tests/test_vocab_parallel.py``): ``wte`` and ``lm_head`` split their
vocabulary over the model axis.

Gloo ranks on the CPU (``tools/parallel_check.py``; one spawn of four
ranks at (dp, sp, tp) = (2, 1, 2), one of two at (1, 1, 2)) against JAX
``make_lm_train_step`` on a mesh of the same shape, the tiny config at 4
heads in fp32, from the JAX weights, on the same global batches:

- ``test_train_parity_vs_replicated`` at T 2, through the fused CE's
  ``vocab_axis`` and through the gathered logits: losses and grad norms to
  1e-5 relative, the parameters to 2e-5 (the key bias to 3 lr);
- ``fused_linear_cross_entropy(vocab_axis=)`` against the JAX one under
  ``shard_map``, forward and backward;
- ``test_vocab_parallel_composes_with_fsdp``: the vocab rules claim
  ``wte`` and ``lm_head``, so FSDP leaves them as model-axis parts, and
  the steps equal JAX's;
- checkpoints across degrees: a T 2 suspend resumes at T 1 and a T 1
  suspend at T 2, each ending where the uninterrupted run of its own
  degree ends; a JAX T 2 ``LMTrainer``'s suspend restores bit for bit;
- the refusals: vocabulary divisibility, vocab parallelism under the
  pipeline, MoE under TP, decoding under TP;
- ``recipes/lm_pretrain.py --device cpu --tiny --model-parallel 2
  --vocab-parallel [--fsdp]`` against its one-device run.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_distributed_tpu.data.tokens import SyntheticTokens as JaxTokens
from pytorch_distributed_tpu.ops.fused_ce import fused_linear_cross_entropy as jax_fused_ce
from pytorch_distributed_tpu.parallel import make_mesh
from pytorch_distributed_tpu.parallel.mesh import shard_map
from pytorch_distributed_tpu.resilience import faults as jfaults
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from pytorch_distributed_tpu.train.lm_trainer import LMTrainerConfig as JaxLMTrainerConfig
from pytorch_distributed_tpu.train.lm_trainer import shard_lm_batch as jax_shard_lm_batch
from pytorch_distributed_tpu.utils.suspend import SuspendWatcher as JaxSuspendWatcher
from pytorch_distributed_tpu_torch.data import SyntheticTokens
from pytorch_distributed_tpu_torch.models import params_to_jax, tiny_config
from pytorch_distributed_tpu_torch.models.generate import init_cache
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.tools import parallel_check
from pytorch_distributed_tpu_torch.train import LMTrainer, LMTrainerConfig
from pytorch_distributed_tpu_torch.train.pp import check_pp_config
from test_torch_tp import (
    LR,
    MODEL,
    SEQ,
    TP2,
    VOCAB,
    as_np,
    assert_params_close,
    close_metrics,
    jax_cfg,
    jax_init,
    jax_state,
    lm_batches,
    spawn,
)

VP = dict(TP2, vocab_parallel=True)
FSDP_POS = dict(max_seq_len=64)  # wpe [64, 32]: over MIN_SHARD_ELEMS


@functools.lru_cache(maxsize=None)
def jax_vp_run(fused: bool, fsdp: bool = False):
    """JAX vocab-parallel TP at (2, 1, 2): three steps (clip 1.0); under
    FSDP with 64 positions, so that ``wpe`` is big enough to store sharded."""
    cfg = jax_cfg(vocab_parallel=True, **(FSDP_POS if fsdp else {}))
    mesh = make_mesh(jax.devices()[:4], data_parallel=2, seq_parallel=1, model_parallel=2)
    state, specs = jax_lm.shard_lm_state(mesh, jax_state(cfg), cfg, fsdp=fsdp)
    step = jax_lm.make_lm_train_step(mesh, state_specs=specs, config=cfg, grad_clip_norm=1.0,
                                     fused_ce=fused, fsdp=fsdp)
    metrics = []
    for b in lm_batches():
        state, m = step(state, jax_shard_lm_batch(mesh, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, as_np(state.params)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ce_job():
    rng = np.random.default_rng(9)
    return dict(task="tp_ops", x=rng.standard_normal((2, 2, 4)).astype(np.float32),
                cot={k: rng.standard_normal((2, 2, 8 if k == "gather" else 4)).astype(np.float32)
                     for k in ("copy", "reduce", "gather")},
                ce=dict(x=rng.standard_normal((37, 16)).astype(np.float32),
                        w=(0.3 * rng.standard_normal((24, 16))).astype(np.float32),
                        labels=rng.integers(0, 24, 37).astype(np.int64),
                        weights=(rng.random(37) > 0.3).astype(np.float32), block_n=16))


@pytest.fixture(scope="module")
def port_vp4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vp4")
    init = jax_init()
    cases = {
        "fused": dict(model=dict(MODEL, **VP), mode="replicated", clip=1.0, params=init),
        "unfused": dict(model=dict(MODEL, **VP), mode="replicated", clip=1.0, params=init,
                        fused_ce=False),
        "fsdp": dict(model=dict(MODEL, **VP, **FSDP_POS), mode="fsdp", clip=1.0,
                     params=jax_init(**FSDP_POS)),
    }
    jobs = {"lm": dict(task="lm", cases=cases, batches=lm_batches(), schedule=SCHED4),
            "ops": ce_job()}
    return spawn(tmp, dict(task="many", jobs=jobs, dp=2, mp=2))


SCHED4 = (LR, 100, 0, LR)


@pytest.mark.parametrize("fused", [True, False])
def test_train_parity_vs_replicated(port_vp4, fused):
    want, want_params = jax_vp_run(fused)
    case = "fused" if fused else "unfused"
    for r in port_vp4:
        close_metrics(r["lm"][case]["metrics"], want)
        # the vocabulary really is split: each rank holds V/T rows
        assert r["lm"][case]["layout"]["wte.weight"] == ("model", 0, 1)
        assert r["lm"][case]["layout"]["lm_head.weight"] == ("model", 0, 1)
    cfg = tiny_config(max_seq_len=SEQ, num_heads=4)
    assert_params_close(params_to_jax(port_vp4[0]["lm"][case]["params"], cfg), want_params)


def test_vocab_parallel_fused_ce_matches_jax(port_vp4):
    """``fused_linear_cross_entropy(vocab_axis=)`` at (2, 1, 2), 37 rows in
    blocks of 16, some weights 0: the loss and dx the same on every rank
    and JAX's, each rank's dW its rows of JAX's kernel gradient."""
    ce = ce_job()["ce"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("model",))

    def loss_fn(x, kernel):
        return jax_fused_ce(x, kernel, jnp.asarray(ce["labels"]), jnp.asarray(ce["weights"]),
                            block_n=ce["block_n"], compute_dtype=jnp.float32,
                            vocab_axis="model")

    def local(x, kernel):
        loss, (dx, dk) = jax.value_and_grad(loss_fn, argnums=(0, 1))(x, kernel)
        return loss[None], dx[None], dk

    f = shard_map(local, mesh=mesh, in_specs=(P(), P(None, "model")),
                  out_specs=(P("model"), P("model"), P(None, "model")), check_vma=False)
    loss, dx, dk = (np.asarray(a) for a in f(jnp.asarray(ce["x"]), jnp.asarray(ce["w"].T)))
    n = ce["w"].shape[0] // 2
    for rank, r in enumerate(port_vp4):
        m = rank % 2  # (d, s, m) = rank // 2, 0, rank % 2
        got_loss, got_dx, got_dw = r["ops"]["ce"]
        np.testing.assert_allclose(got_loss, loss[m], rtol=1e-6)
        np.testing.assert_allclose(got_dx.numpy(), dx[m], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_dw.numpy(), dk[:, m * n:(m + 1) * n].T, rtol=1e-5,
                                   atol=1e-6)


def test_vocab_parallel_composes_with_fsdp(port_vp4):
    """The vocab rules claim wte and lm_head: FSDP leaves them as model-axis
    parts and ZeRO-shards only the unclaimed big leaves (wpe); the steps
    equal JAX's ``fsdp=True`` vocab-parallel step."""
    want, want_params = jax_vp_run(True, fsdp=True)
    for r in port_vp4:
        got = r["lm"]["fsdp"]
        close_metrics(got["metrics"], want)
        assert got["layout"]["wte.weight"] == ("model", 0, 1)
        assert got["layout"]["lm_head.weight"] == ("model", 0, 1)
        assert got["layout"]["wpe.weight"] == ("data", 0, 1)
        assert got["layout"]["blocks.0.attn.qkv.weight"] == ("model", 0, 3)
    cfg = tiny_config(num_heads=4, **FSDP_POS)
    assert_params_close(params_to_jax(port_vp4[0]["lm"]["fsdp"]["params"], cfg), want_params)


# ---- checkpoints across degrees ----

def trainer_run(save_dir, tp: bool, suspend_at=None) -> dict:
    model = dict(MODEL, **VP) if tp else MODEL
    return dict(model=model, batch=2, seq=SEQ, n_train=16, n_val=4, suspend_at=suspend_at,
                config=dict(epochs=1, batch_size=2, lr=3e-4, warmup_steps=0, log_every=1,
                            save_dir=str(save_dir)))


@pytest.fixture(scope="module")
def degrees(tmp_path_factory):
    """T 1 in this process, T 2 on two ranks: each suspended after step 2
    and resumed at the other degree, and each uninterrupted."""
    tmp = tmp_path_factory.mktemp("degrees")
    cpu = torch.device("cpu")

    def one(runs):
        return parallel_check._trainer(dict(runs=runs), None, cpu)

    t1_suspended = one([trainer_run(tmp / "y", False, 2)])[0]
    tp = spawn(tmp, dict(task="trainer", mp=2, runs=[
        trainer_run(tmp / "a", True), trainer_run(tmp / "x", True, 2),
        trainer_run(tmp / "y", True)]))[0]
    t1_full, t1_resumed = one([trainer_run(tmp / "b", False), trainer_run(tmp / "x", False)])
    return {"t1 suspended": t1_suspended, "tp full": tp[0], "tp suspended": tp[1],
            "tp resumed": tp[2], "t1 full": t1_full, "t1 resumed": t1_resumed}


@pytest.mark.parametrize("suspended,resumed,full", [
    ("tp suspended", "t1 resumed", "t1 full"), ("t1 suspended", "tp resumed", "tp full")])
def test_checkpoints_interchange_across_degrees(degrees, suspended, resumed, full):
    """A suspend at one degree resumes at the other and ends where the
    uninterrupted run of that degree ends (2e-5, the key bias 4 lr):
    saved leaves are global, a restore takes each rank's part."""
    assert degrees[suspended]["suspended"] and degrees[suspended]["step"] == 2
    got, want = degrees[resumed], degrees[full]
    assert not got["suspended"] and got["step"] == want["step"] == 8
    cfg = tiny_config(max_seq_len=SEQ, num_heads=4)
    assert_params_close(params_to_jax(got["params"], cfg), params_to_jax(want["params"], cfg),
                        2e-5, 4 * LR)


def test_a_jax_tp_checkpoint_restores_into_the_port(tmp_path):
    """JAX ``LMTrainer`` at T 2 (vocab-parallel) on two devices, suspended
    after step 2: the port at T 1 reads its leaves back bit for bit."""
    spec = [jfaults.FaultSpec("train.step", "suspend", at=2)]
    jfaults.install_plan(jfaults.FaultPlan(spec))
    try:
        cfg = JaxLMTrainerConfig(epochs=1, batch_size=2, lr=3e-4, warmup_steps=0, log_every=0,
                                 save_dir=str(tmp_path), flush_every=0,
                                 metrics_out=str(tmp_path / "metrics.jsonl"))
        jt = JaxLMTrainer(jax_cfg(vocab_parallel=True), JaxTokens(16, SEQ, VOCAB),
                          JaxTokens(4, SEQ, VOCAB, seed=1), cfg,
                          mesh=make_mesh(jax.devices()[:2], data_parallel=1, model_parallel=2),
                          suspend_watcher=JaxSuspendWatcher(install_handlers=False))
        with pytest.raises(SystemExit):
            jt.fit()
    finally:
        jfaults.clear_plan()
    want = as_np(jt.state.params)
    port = LMTrainer(tiny_config(max_seq_len=SEQ, num_heads=4, attention="dense"),
                     SyntheticTokens(16, SEQ, VOCAB), SyntheticTokens(4, SEQ, VOCAB, seed=1),
                     LMTrainerConfig(epochs=1, batch_size=2, save_dir=str(tmp_path)),
                     device="cpu")
    assert port.try_resume()
    assert port.state.step == int(jt.state.step) == 3
    got = params_to_jax(port.state.model.state_dict(), tiny_config(max_seq_len=SEQ, num_heads=4))
    assert_params_close(got, want, 0.0, 0.0)


# ---- refusals ----

def test_the_vocabulary_must_divide_by_the_degree():
    with pytest.raises(ValueError, match="not divisible"):
        tiny_config(vocab_size=97, model_axis="model", tp_size=2, vocab_parallel=True)
    with pytest.raises(ValueError, match="requires model_axis"):
        tiny_config(tp_size=2)


def test_vocab_parallelism_is_refused_under_the_pipeline(tmp_path):
    from pytorch_distributed_tpu_torch.recipes import lm_pretrain

    with pytest.raises(ValueError, match="vocab_parallel"):
        check_pp_config(dataclasses.replace(tiny_config(num_layers=4), vocab_parallel=True), 2)
    with pytest.raises(SystemExit, match="--vocab-parallel"):
        lm_pretrain.main(["--device", "cpu", "--tiny", "--pipeline-stages", "2",
                          "--vocab-parallel", "--save-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="needs --model-parallel"):
        lm_pretrain.main(["--device", "cpu", "--tiny", "--vocab-parallel",
                          "--save-dir", str(tmp_path)])


def test_moe_and_decoding_under_tp_are_refused():
    """MoE under TP is still refused; decoding under TP now runs
    (``tests/test_torch_serving_tp.py``), but never without a model axis
    of the config's size: a TP model's caches hold its ranks' heads."""
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(NotImplementedError, match="item 6.4"):
        tiny_config(n_experts=4, **TP2)
    model = TransformerLM(tiny_config(**VP))
    tokens = torch.ones((1, 4), dtype=torch.long)
    make_mesh(1)  # a model axis of one rank
    with pytest.raises(ValueError, match="!= tp_size 2"):
        model(tokens, 0, cache=init_cache(model.cfg, 1, "cpu"))
    with pytest.raises(ValueError, match="!= tp_size 2"):
        model(tokens[:, :1], 4, cache=init_cache(model.cfg, 1, "cpu"), decode=True)


# ---- the recipe ----

@pytest.mark.parametrize("fsdp", [False, True])
def test_the_recipe_runs_vocab_parallel_on_cpu_ranks(tmp_path, fsdp):
    """``--model-parallel 2 --vocab-parallel [--fsdp]`` on two gloo ranks:
    its validation loss is the one-device run's."""
    from pytorch_distributed_tpu_torch.recipes import lm_pretrain

    base = ["--device", "cpu", "--tiny", "--epochs", "1", "--steps", "2", "--log-every", "1"]
    got = lm_pretrain.main([*base, "--model-parallel", "2", "--vocab-parallel",
                            *(["--fsdp"] if fsdp else []), "--save-dir", str(tmp_path / "tp")])
    want = lm_pretrain.train(lm_pretrain._parse([*base, "--save-dir", str(tmp_path / "one")]),
                             device="cpu")
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
