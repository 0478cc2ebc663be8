"""``chip_smoke.py``'s FSDP and pipeline phase rehearsed on the CPU.

The phase end to end with two CPU ranks over gloo at a small size (2
layers, 2 heads of 64, L = 64, a global batch of 4, 2 microbatches; the
tiny Bottleneck ResNet at 16^2, B = 2 a rank): FSDP and replicated DP with
FSDP's first step against the one-device step and FSDP's validation
against replicated DP's, the pipeline and its validation against the
sequential reference, the ResNet ``Trainer(fsdp=True)`` and its
validation against the replicated one, the launch counts (none: CPU
tensors run the plain versions) and the two recipes to their end.
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


def test_parallel_phase_rehearses_on_cpu(chip_smoke, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(chip_smoke, "RING_MODEL", dict(vocab_size=128, num_layers=2,
                                                       num_heads=2, embed_dim=128))
    monkeypatch.setattr(chip_smoke, "PARALLEL", dict(batch=4, seq=64, steps=3, microbatches=2,
                                                     profiled=1, recipe_steps=2, timeout_s=120))
    monkeypatch.setattr(chip_smoke, "DP", dict(batch=2, steps=3, recipe_batch=2, recipe_steps=2,
                                               timeout_s=120))
    monkeypatch.setattr(chip_smoke, "DP_MODEL", dict(stage_sizes=(1, 1), block="bottleneck",
                                                     num_classes=10, num_filters=16))
    monkeypatch.setattr(chip_smoke, "DP_SIZE", 16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.parallel_runs(torch, "CPU", str(tmp_path), dev="cpu")
    finally:
        torch.set_num_threads(threads)
    text = capsys.readouterr().out
    assert "backend gloo, 2 ranks on 1 card" in text and "FAIL" not in text
    assert text.count(" ok\n") == 12, text
    assert "LM FSDP first step vs one card" in text
    assert "LM FSDP validation vs replicated DP" in text
    assert "LM pipeline validation vs the reference's weights" in text
    assert "ResNet-50 Trainer(fsdp=True) vs the replicated trainer" in text
    assert "ResNet-50 FSDP validation vs the replicated trainer" in text
    assert "recipes/lm_pretrain.py --pipeline-stages 2: validation loss" in text
    assert all(v == 0 for v in out["flash_launches"].values())  # plain versions
    assert all(v == 0 for v in out["tail_launches"].values())
    assert all(x <= chip_smoke.FSDP_STATE_SHARE for x in out["state_share"])
    # on the CPU FSDP and the pipeline agree with their references to fp32
    # summation order, far inside the card's tolerances
    for errs in (out["fsdp_errs"], out["pp_errs"]):
        assert max(max(v) for v in errs.values()) < 1e-4, errs
    # two ranks sum in one order whatever the collective: ResNet FSDP is
    # the replicated run, bit for bit
    assert out["resnet_errs"] == {"loss": [0.0, 0.0, 0.0], "val": 0.0}, out["resnet_errs"]


@pytest.mark.parametrize("stages,want", [(2, 48), (4, 24), (1, 96)])
def test_pipeline_launches_are_the_stages_layers_a_microbatch(chip_smoke, stages, want):
    assert chip_smoke.pp_launches(12, stages, 8) == want
