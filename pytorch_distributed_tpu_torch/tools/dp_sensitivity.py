"""How sensitive ResNet-50's first gradient is, which sets how closely
``chip_smoke.py``'s data-parallel phase can hold the ranks to a reference.

On the card, fp32, plain blocks, the seed-0 weights, one synthetic batch
of ``--batch`` 224^2 images: the step-0 gradient with the input multiplied
by ``1 + eps·N(0, 1)`` against the unperturbed one, for each ``--eps``
(0: the same input again, which is what the card repeats; then
rounding-level noise), as relative errors of the loss, the whole gradient
and its norm, with the tensors that move most; then the combined step-0
gradient on 2 gloo ranks sharing the card (``tools/dp_check.py``) against
one rank on the whole batch, with sync-BN (what the DP phase holds to a
tolerance) and without it (each rank its own statistics: what a sum left
out of sync-BN would give).

    python -m pytorch_distributed_tpu_torch.tools.dp_sensitivity [--batch 64]
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile

import torch

from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.tools import dp_check
from pytorch_distributed_tpu_torch.train import create_resnet_state

LR = 0.1


def rel(got: dict, want: dict) -> float:
    num = sum(float((got[k].cpu() - want[k].cpu()).norm()) ** 2 for k in want)
    return (num / sum(float(w.norm()) ** 2 for w in want.values())) ** 0.5


def worst(got: dict, want: dict, n: int = 4) -> list:
    errs = sorted(((float((got[k].cpu() - w.cpu()).norm() / w.norm()), k)
                   for k, w in want.items()), reverse=True)
    return [(k, f"{e:.1e}") for e, k in errs[:n]]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--eps", type=float, nargs="+", default=[0.0, 1e-7, 1e-6])
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    spec = dict(dp_check.RESNET50, dtype="float32")
    batch = dp_check.global_batches(dict(data=dict(n=1, batch=args.batch, size=224,
                                                   classes=1000, seed=3)))[0]
    labels = torch.from_numpy(batch["label"]).cuda()

    def grads(images):
        state = create_resnet_state(dp_check.build_model(spec), lr_schedule=lambda s: LR,
                                    device="cuda")
        state.model.train()
        loss = cross_entropy_loss(state.model(images), labels)
        loss.backward()
        return loss.item(), {k: q.grad.detach().cpu() for k, q in state.model.named_parameters()}

    x = torch.from_numpy(batch["image"]).cuda()
    loss0, g0 = grads(x)
    norm0 = sum(float(g.norm()) ** 2 for g in g0.values()) ** 0.5
    for eps in args.eps:
        loss1, g1 = grads(x * (1 + eps * torch.randn_like(x)))
        norm1 = sum(float(g.norm()) ** 2 for g in g1.values()) ** 0.5
        print(f"input noise {eps:g}: loss {abs(loss1 - loss0) / loss0:.2e}, gradient "
              f"{rel(g1, g0):.2e}, its norm {abs(norm1 - norm0) / norm0:.2e} (relative); "
              f"most moved {worst(g1, g0)}")
    with tempfile.TemporaryDirectory() as tmp:
        job = dict(task="steps", backend="gloo", rendezvous=f"file://{tmp}/rendezvous",
                   out=f"{tmp}/out", device="cuda", timeout_s=300, batches=[batch],
                   cases={name: dict(model=dict(spec, sync_bn=synced), schedule=(LR, 1, 30, 0.1))
                          for name, synced in (("sync-BN", True), ("per-replica BN", False))})
        dp_check.run(job, 2)
        got = dp_check.load(job, 2)[0]
    for name, r in got.items():
        print(f"{name} on 2 ranks vs one rank on the batch, step-0 gradient "
              f"{rel(r['grad_first'], g0):.2e} (relative); most moved {worst(r['grad_first'], g0)}")


if __name__ == "__main__":
    main()
