"""The GPipe pipeline in the port against the JAX package's.

Two gloo ranks on the CPU, the stages of a 1 x 1 x 2 grid
(``tools/parallel_check.py``, one spawn running every case), against JAX
``gpipe`` under ``shard_map`` and ``make_pp_reference_step`` on one
device, the tiny configs in fp32 (two layers, one a stage), from the JAX
weights:

- the toy stage of ``tests/test_pipeline.py`` (``relu(x @ w + b)``) at 1
  and 4 microbatches: the outputs and every stage's gradients of Σ y²;
- three LM steps at S 2, M 2, against the JAX sequential reference on the
  same stacked parameters: the plain CE on full logits, the fused CE, and
  a MoE config (4 experts in every block) whose aux losses enter the
  loss; losses to 1e-5 relative, parameters to 2e-5 absolute (the key
  bias, whose gradient is rounding noise AdamW scales to about lr a step,
  to 3 steps' lr); clipping and dropout against the port's own
  sequential reference, grad norms included;
- every stage ends with the same embedding and head, bit for bit;
- a pipeline trainer suspended after step 2 and resumed ends bit for bit
  where the uninterrupted one does; a JAX pipeline trainer's suspend
  checkpoint restores into the port's stages bit for bit;
- the JAX refusals, with the JAX messages, and the recipe's;
- ``recipes/lm_pretrain.py --device cpu --tiny --pipeline-stages 2`` runs
  to its end.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_distributed_tpu.data.tokens import SyntheticTokens as JaxTokens
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.optim import build_optimizer as jax_build_optimizer
from pytorch_distributed_tpu.ops.schedules import warmup_cosine as jax_warmup_cosine
from pytorch_distributed_tpu.parallel import make_mesh
from pytorch_distributed_tpu.parallel.mesh import shard_map
from pytorch_distributed_tpu.parallel.pipeline import gpipe as jax_gpipe
from pytorch_distributed_tpu.parallel.pipeline import last_stage_value
from pytorch_distributed_tpu.resilience import faults as jfaults
from pytorch_distributed_tpu.train import pp as jax_pp
from pytorch_distributed_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from pytorch_distributed_tpu.train.lm_trainer import LMTrainerConfig as JaxLMTrainerConfig
from pytorch_distributed_tpu.utils.suspend import SuspendWatcher as JaxSuspendWatcher
from pytorch_distributed_tpu_torch.data import SyntheticTokens
from pytorch_distributed_tpu_torch.models import tiny_config
from pytorch_distributed_tpu_torch.models.convert import pp_params_from_jax, pp_params_to_jax
from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup, Mesh
from pytorch_distributed_tpu_torch.recipes import lm_pretrain
from pytorch_distributed_tpu_torch.tools import parallel_check
from pytorch_distributed_tpu_torch.train import LMTrainer, LMTrainerConfig, lm_collate
from pytorch_distributed_tpu_torch.train import pp

SEQ, BATCH, VOCAB, STAGES, MICRO = 16, 4, 128, 2, 2
SCHED = (3e-4, 100, 0, 3e-4)  # warmup_cosine: lr 3e-4 throughout
LR = SCHED[0]
D, TOY_N = 16, 16
MODEL = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=SEQ,
             dtype="float32", attention="dense")
LM_CASES = {"plain ce": (dict(), False), "fused ce": (dict(), True),
            "moe": (dict(n_experts=4, moe_every=1), True)}


def lm_batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [lm_collate(list(rng.integers(1, VOCAB, (BATCH, SEQ)).astype(np.int32)))
            for _ in range(n)]


def toy_inputs():
    rng = np.random.default_rng(0)
    return {"w": (rng.normal(size=(STAGES, D, D)) * 0.5).astype(np.float32),
            "b": (rng.normal(size=(STAGES, D)) * 0.1).astype(np.float32),
            "x": rng.normal(size=(TOY_N, D)).astype(np.float32)}


def as_np(tree):
    return jax.tree.map(lambda x: np.array(jax.device_get(x)), tree)


def jax_tx():
    return jax_build_optimizer("adamw", jax_warmup_cosine(*SCHED), weight_decay=0.1)


def jax_pp_state(extra: dict):
    cfg = jax_tiny_config(attention="dense", max_seq_len=SEQ, **extra)
    return cfg, jax_pp.create_pp_lm_state(cfg, STAGES, jax_tx(), jax.random.key(0),
                                          init_len=SEQ)


@functools.lru_cache(maxsize=None)
def jax_reference(name: str):
    extra, fused = LM_CASES[name]
    cfg, state = jax_pp_state(extra)
    step = jax_pp.make_pp_reference_step(cfg, STAGES, jax_tx(), n_microbatches=MICRO,
                                         fused_ce=fused)
    losses = []
    for b in lm_batches():
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, as_np(state.params)


def jax_toy(n_micro: int):
    """JAX ``gpipe`` on a 1 x 2 (data x model) mesh: the outputs and the
    gradients of Σ y² (``tests/test_pipeline.py``'s harness)."""
    t = toy_inputs()
    mesh = make_mesh(jax.devices()[:STAGES], data_parallel=1, model_parallel=STAGES)
    specs = {"w": P("model"), "b": P("model")}

    def stage_fn(p, x, mb_idx):
        return jax.nn.relu(x @ p["w"] + p["b"])

    def fn(params, x):
        out = jax_gpipe(stage_fn, jax.tree.map(lambda a: a[0], params),
                        x.reshape(n_micro, -1, D), axis="model")
        return last_stage_value(out).reshape(x.shape)

    pipe = jax.jit(shard_map(fn, mesh=mesh, in_specs=(specs, P("data")), out_specs=P("data"),
                             check_vma=False))
    params = jax.device_put({"w": t["w"], "b": t["b"]},
                            jax.tree.map(lambda s: NamedSharding(mesh, s), specs))
    x = jax.device_put(t["x"], NamedSharding(mesh, P("data")))
    out = pipe(params, x)
    grads = jax.grad(lambda p, x: jnp.sum(pipe(p, x) ** 2))(params, x)
    return np.asarray(out), as_np(grads)


def jax_pp_checkpoint(save_dir):
    """A JAX pipeline trainer on two devices, suspended after step 2:
    its parameters at the save."""
    spec = [jfaults.FaultSpec("train.step", "suspend", at=2)]
    jfaults.install_plan(jfaults.FaultPlan(spec))
    try:
        cfg = JaxLMTrainerConfig(epochs=1, batch_size=2, lr=LR, warmup_steps=0, log_every=0,
                                 save_dir=str(save_dir), flush_every=0, pipeline_stages=STAGES,
                                 pp_microbatches=MICRO,
                                 metrics_out=str(save_dir / "metrics.jsonl"))
        jt = JaxLMTrainer(jax_tiny_config(attention="dense", max_seq_len=SEQ),
                          JaxTokens(16, SEQ, VOCAB), JaxTokens(4, SEQ, VOCAB, seed=1), cfg,
                          mesh=make_mesh(jax.devices()[:STAGES], data_parallel=1,
                                         model_parallel=STAGES),
                          suspend_watcher=JaxSuspendWatcher(install_handlers=False))
        with pytest.raises(SystemExit):
            jt.fit()
    finally:
        jfaults.clear_plan()
    return as_np(jt.state.params), int(jt.state.step)


def trainer_run(save_dir, suspend_at=None, restore_only=False, **over) -> dict:
    config = dict(epochs=1, batch_size=2, lr=LR, warmup_steps=0, log_every=1,
                  save_dir=str(save_dir), pipeline_stages=STAGES, pp_microbatches=MICRO)
    config.update(over)
    return dict(model=MODEL, batch=2, seq=SEQ, n_train=8, n_val=4, suspend_at=suspend_at,
                restore_only=restore_only, config=config)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process, as the gloo ranks it spawns take:
    the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_pp")
    return d, *jax_pp_checkpoint(d)


@pytest.fixture(scope="module")
def port(tmp_path_factory, jax_ckpt):
    tmp = tmp_path_factory.mktemp("pp")
    cases = {}
    for name, (extra, fused) in LM_CASES.items():
        _, state = jax_pp_state(extra)
        cases[name] = dict(model=dict(MODEL, **extra), mode="pp", fused_ce=fused,
                           microbatches=MICRO, params=pp_params_from_jax(as_np(state.params)))
    cases["clip + dropout"] = dict(model=dict(MODEL, dropout=0.1), mode="pp", clip=0.05,
                                   microbatches=MICRO, dropout_seed=7)
    t = toy_inputs()
    jobs = {f"toy M={m}": dict(task="toy", microbatches=m, **t) for m in (1, 4)}
    jobs["lm"] = dict(task="lm", cases=cases, batches=lm_batches(),
                      val_batches=lm_batches(1, seed=9), schedule=SCHED)
    jobs["trainer"] = dict(task="trainer", runs=[
        trainer_run(tmp / "full"), trainer_run(tmp / "cut", suspend_at=2),
        trainer_run(tmp / "cut"), trainer_run(jax_ckpt[0], restore_only=True)])
    job = dict(task="many", jobs=jobs, mp=STAGES, backend="gloo",
               rendezvous=f"file://{tmp}/rendezvous", out=str(tmp / "out"), device="cpu",
               timeout_s=120)
    parallel_check.run(job, STAGES)
    return parallel_check.load(job)


@pytest.mark.parametrize("n_micro", [1, 4])
def test_gpipe_matches_jax_gpipe_values_and_grads(port, n_micro):
    out, grads = jax_toy(n_micro)
    res = [r[f"toy M={n_micro}"] for r in port]
    np.testing.assert_allclose(res[-1]["out"].numpy(), out, rtol=1e-5, atol=1e-6)
    for s, r in enumerate(res):
        np.testing.assert_allclose(r["dw"].numpy(), grads["w"][s], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["db"].numpy(), grads["b"][s], rtol=1e-4, atol=1e-5)


def assert_stacked_close(got: dict, want: dict, atol: float, key_bias_atol: float):
    got, want = jax.tree.map(np.array, got), jax.tree.map(np.array, want)
    for p in (got, want):
        for layer in p["stages"].values():
            if "qkv" in layer["attn"]:
                layer["k_bias"] = layer["attn"]["qkv"]["bias"][:, 1].copy()
                layer["attn"]["qkv"]["bias"][:, 1] = 0.0
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    assert tg == tw
    for (path, a), (_, b) in zip(fg, fw):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, rtol=0, err_msg=name,
                                   atol=key_bias_atol if "k_bias" in name else atol)


@pytest.mark.parametrize("name", list(LM_CASES))
def test_pp_steps_match_the_jax_sequential_reference(port, name):
    want, want_params = jax_reference(name)
    for r in port:
        got = r["lm"][name]
        np.testing.assert_allclose(got["metrics"]["loss"], want, rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["pp_bubble_frac"], [1 / 3] * 3, rtol=1e-7)
        assert got["metrics"]["launches"] == [[0, 0]] * 3  # CPU tensors: no kernel
    cfg = tiny_config(attention="dense", max_seq_len=SEQ, **LM_CASES[name][0])
    assert_stacked_close(pp_params_to_jax(port[0]["lm"][name]["params"], cfg), want_params,
                         2e-5, 3 * LR)


def test_pp_clip_and_dropout_match_the_ports_sequential_reference(port):
    cfg = tiny_config(attention="dense", max_seq_len=SEQ, dropout=0.1)
    state = pp.create_pp_reference_state(cfg, STAGES, lr_schedule=warmup_cosine(*SCHED),
                                         weight_decay=0.1, device="cpu")
    step = pp.make_pp_reference_step(cfg, STAGES, MICRO, dropout_seed=7, grad_clip_norm=0.05)
    want = {"loss": [], "grad_norm": []}
    for b in lm_batches():
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in want:
            want[k].append(float(m[k]))
    for r in port:
        for k in want:
            np.testing.assert_allclose(r["lm"]["clip + dropout"]["metrics"][k], want[k],
                                       rtol=1e-5, err_msg=k)
    got = port[0]["lm"]["clip + dropout"]["params"]
    for k, v in state.model.stacked_state_dict().items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=2e-5 if "qkv.bias" not in k
                                   else 3 * LR, err_msg=k)


def test_every_stage_ends_with_the_same_embedding_and_head(port):
    for name in list(LM_CASES) + ["clip + dropout"]:
        a, b = (r["lm"][name]["replicated"] for r in port)
        assert set(a) == set(b) and a
        for k in a:
            assert a[k] == b[k], (name, k)  # SHA-256 digests of the leaves


def test_pp_eval_sums_the_last_stage(port):
    for r in port:
        val = r["lm"]["fused ce"]["val"]
        assert val["tokens"] == BATCH * (SEQ - 1)
        assert np.isfinite(val["loss_sum"]) and val["loss_sum"] > 0


def test_a_suspended_pipeline_run_resumes_bitwise(port):
    full, cut, resumed = (port[0]["trainer"][i] for i in range(3))
    assert cut["suspended"] and cut["step"] == 2
    assert not resumed["suspended"] and resumed["step"] == full["step"] == 4
    assert [h["loss"] for h in resumed["history"]] == [h["loss"] for h in full["history"][2:]]
    for k, v in full["params"].items():
        assert torch.equal(resumed["params"][k], v), k


def test_a_jax_pipeline_checkpoint_restores_into_the_stages(port, jax_ckpt):
    _, want, step = jax_ckpt
    restored = port[0]["trainer"][3]
    assert restored["step"] == step
    got = pp_params_to_jax(restored["params"], tiny_config(max_seq_len=SEQ))
    assert_stacked_close(got, want, 0.0, 0.0)


def test_pp_params_cross_from_jax_and_back():
    _, state = jax_pp_state(dict(n_experts=4, moe_every=1))
    tree = as_np(state.params)
    back = pp_params_to_jax(pp_params_from_jax(tree),
                            tiny_config(max_seq_len=SEQ, n_experts=4, moe_every=1))
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def port_trainer(config: LMTrainerConfig, mesh=None, model=None):
    return LMTrainer(model or tiny_config(attention="dense", max_seq_len=SEQ),
                     SyntheticTokens(8, SEQ, VOCAB), SyntheticTokens(4, SEQ, VOCAB, seed=1),
                     config, device="cpu", mesh=mesh)


def jax_trainer(config: JaxLMTrainerConfig, devices, **mesh_kw):
    return JaxLMTrainer(jax_tiny_config(attention="dense", max_seq_len=SEQ),
                        JaxTokens(8, SEQ, VOCAB), JaxTokens(4, SEQ, VOCAB, seed=1), config,
                        mesh=make_mesh(devices, **mesh_kw))


def fake_mesh(seq: int, model: int) -> Mesh:
    """A grid's sizes as one rank sees them (its groups never used: the
    trainer refuses it before any collective)."""
    return Mesh(AxisGroup(None, 1, 0), AxisGroup(None, seq, 0), AxisGroup(None, model, 0))


@pytest.mark.parametrize("case", ["nan_guard", "model axis", "seq axis", "fsdp"])
def test_the_trainer_refuses_as_jax_does(tmp_path, case):
    over, seq, model = {"nan_guard": ({"nan_guard": True}, 1, 2),
                        "model axis": ({}, 1, 1), "seq axis": ({}, 2, 2),
                        "fsdp": ({"fsdp": True}, 1, 2)}[case]
    common = dict(batch_size=2, save_dir=str(tmp_path), pipeline_stages=STAGES, **over)
    mine = _message(lambda: port_trainer(LMTrainerConfig(**common), fake_mesh(seq, model)))
    theirs = _message(lambda: jax_trainer(
        JaxLMTrainerConfig(flush_every=0, metrics_out=str(tmp_path / "m.jsonl"), **common),
        jax.devices()[:seq * model], data_parallel=1, seq_parallel=seq,
        model_parallel=model))
    assert mine == theirs


@pytest.mark.parametrize("layers,extra", [(3, {}), (2, dict(n_experts=4, moe_every=2))])
def test_pp_state_checks_match_jax(layers, extra):
    mine = _message(lambda: pp.create_pp_lm_state(
        tiny_config(num_layers=layers, **extra), STAGES, lr_schedule=lambda s: 0.0,
        device="cpu"))
    theirs = _message(lambda: jax_pp.create_pp_lm_state(
        jax_tiny_config(num_layers=layers, **extra), STAGES, jax_tx(), jax.random.key(0)))
    assert mine == theirs


def test_microbatches_clamp_to_a_divisor_of_the_batch():
    assert pp.pp_microbatches(8, 6) == (
        6, "pp_microbatches 8 -> 6 (must divide the per-shard batch 6)")
    assert pp.pp_microbatches(4, 6) == (3, "pp_microbatches 4 -> 3 (must divide the "
                                           "per-shard batch 6)")
    assert pp.pp_microbatches(2, 8) == (2, None)
    with pytest.raises(ValueError, match="pp_microbatches must be >= 1"):
        pp.pp_microbatches(0, 8)


def test_the_recipe_refuses_as_the_jax_recipe_does(monkeypatch, capsys):
    monkeypatch.delenv("MASTER_IP", raising=False)
    with pytest.raises(SystemExit, match="--pipeline-stages must be >= 1"):
        lm_pretrain.main(["--tiny", "--pipeline-stages", "-1"])
    with pytest.raises(SystemExit, match="drop --model-parallel"):
        lm_pretrain.main(["--tiny", "--pipeline-stages", "2", "--model-parallel", "2"])
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--pipeline-stages 2 needs a card per rank"):
        lm_pretrain.main(["--tiny", "--pipeline-stages", "2", "--seq-parallel", "2"])
    assert "overriding --seq-parallel 2 -> 1" in capsys.readouterr().out
    monkeypatch.setattr("torch.cuda.device_count", lambda: 4)
    args = lm_pretrain._parse(["--tiny", "--pipeline-stages", "2"])
    assert lm_pretrain.grid(args) == (2, 4)  # as JAX: dp = devices // (sp * stages)


def test_the_recipe_runs_the_pipeline_on_cpu_ranks(tmp_path):
    summary = lm_pretrain.main(["--device", "cpu", "--tiny", "--pipeline-stages", "2",
                                "--epochs", "1", "--steps", "2", "--log-every", "1",
                                "--save-dir", str(tmp_path / "out")])
    assert np.isfinite(summary["loss"]) and summary["ppl"] > 1.0, summary
