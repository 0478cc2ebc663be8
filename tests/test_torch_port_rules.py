"""Rules of the port package: it imports no JAX and nothing of the JAX
package, and its entry points run on CUDA unless asked for the CPU —
without a card they raise, they never carry on quietly on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch import resolve_device
from pytorch_distributed_tpu_torch.models import init_params, params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.serving import PagedEngine, Scheduler

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pytorch_distributed_tpu_torch"
FORBIDDEN = ("jax", "flax", "jaxlib", "pytorch_distributed_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_port_imports_in_a_process_without_jax():
    """Importing every module of the port loads no JAX module."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import pytorch_distributed_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'jaxlib', 'pytorch_distributed_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def _state():
    cfg = tiny_config(max_seq_len=32)
    return cfg, params_from_jax(init_params(cfg, seed=0))


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, state = _state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(cfg, state, 2, block_len=8, prefill_chunk=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(cfg, state, 2, block_len=8, prefill_chunk=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler(cfg, state, 2, block_len=8, prefill_chunk=8, device="cuda")
    with pytest.raises(RuntimeError):
        resolve_device()
    # an explicit CPU request is honoured
    s = Scheduler(cfg, state, 2, block_len=8, prefill_chunk=8, device="cpu")
    s.submit(np.arange(1, 6), 2)
    assert len(s.drain()[0]) == 2
    assert s.engine.device.type == "cpu"


def test_fleet_entry_points_raise_without_a_card(monkeypatch):
    """The router, the gateway's fleet and the recipe's fleet path: CUDA
    unless asked for the CPU, every visible card by default."""
    from pytorch_distributed_tpu_torch.fleet import FleetRouter
    from pytorch_distributed_tpu_torch.fleet.router import fleet_devices
    from pytorch_distributed_tpu_torch.recipes import serve_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, state = _state()
    kw = dict(n_slots=2, block_len=8, prefill_chunk=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetRouter(cfg, state, **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetRouter(cfg, state, device="cuda", **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetRouter(cfg, state, devices=["cuda:0", "cuda:1"], **kw)
    for flags in (["--replicas", "2"], ["--replicas", "2", "--disaggregate"],
                  ["--async-host"], ["--http-port", "0", "--http-duration", "0"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_lm.main(["--tiny", "--requests", "1", *flags])
    with pytest.raises(ValueError, match="not both"):
        fleet_devices(devices=["cpu"], device="cpu")
    r = FleetRouter(cfg, state, device="cpu", **kw)
    assert [s.engine.device.type for s in r.replicas] == ["cpu", "cpu"]
    assert r.replicas[0].engine.model is r.replicas[1].engine.model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert fleet_devices() == [torch.device("cuda", i) for i in range(3)]


def test_resolve_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("cuda:0") == torch.device("cuda:0")
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")


def test_recipe_without_device_raises_on_a_cpu_machine(monkeypatch):
    from pytorch_distributed_tpu_torch.recipes import serve_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main(["--tiny", "--requests", "1"])


def test_training_entry_points_raise_without_a_card(monkeypatch):
    from pytorch_distributed_tpu_torch.data import SyntheticTokens
    from pytorch_distributed_tpu_torch.recipes import lm_pretrain
    from pytorch_distributed_tpu_torch.train import (
        LMTrainer,
        LMTrainerConfig,
        create_lm_state,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(max_seq_len=16)
    data = SyntheticTokens(4, 16, cfg.vocab_size)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMTrainer(cfg, data, data, LMTrainerConfig(batch_size=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_lm_state(cfg, lr_schedule=lambda s: 0.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_pretrain.main(["--tiny", "--steps", "1"])
    # an explicit CPU request is honoured
    trainer = LMTrainer(cfg, data, data, LMTrainerConfig(batch_size=2), device="cpu")
    assert trainer.device.type == "cpu"
    assert next(trainer.state.model.parameters()).device.type == "cpu"


def test_resnet_entry_points_raise_without_a_card(monkeypatch):
    from pytorch_distributed_tpu_torch.data import SyntheticImageClassification
    from pytorch_distributed_tpu_torch.models.resnet import BasicBlock, ResNet
    from pytorch_distributed_tpu_torch.recipes import resnet_single
    from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig, create_resnet_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def tiny():
        return ResNet(stage_sizes=(1,), block_cls=BasicBlock, num_classes=2, num_filters=8)

    data = SyntheticImageClassification(4, 8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tiny(), data, data, TrainerConfig(batch_size=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_resnet_state(tiny(), lr_schedule=lambda s: 0.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet_single.main(["--tiny", "--synthetic"])
    trainer = Trainer(tiny(), data, data, TrainerConfig(batch_size=2), device="cpu")
    assert next(trainer.state.model.parameters()).device.type == "cpu"


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the machine has
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    r = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script fails and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    r = _run_smoke(tmp_path, lone)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
