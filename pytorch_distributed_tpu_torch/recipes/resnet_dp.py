"""ResNet-50, data parallel over this machine's cards (the port of
``recipes/resnet_dp.py``).

The reference's ``nn.DataParallel`` scatters a global batch from one
process every step; the JAX recipe runs one SPMD program over the local
devices. Here a rank takes each visible card, the ranks meet through a
file in a temporary directory over NCCL and average their gradients each
step: fp32, SGD(0.1, momentum 0.9, weight decay 1e-4), StepLR(30, 0.1),
batch 400 a card, through ``Trainer`` (``recipes.common.launch``):

    python -m pytorch_distributed_tpu_torch.recipes.resnet_dp --synthetic
    python -m pytorch_distributed_tpu_torch.recipes.resnet_dp --data-dir D --raw
    python -m pytorch_distributed_tpu_torch.recipes.resnet_dp --device cpu --tiny \
        --synthetic --cpu-replicas 2

Without ``--device`` it runs on CUDA and fails where there is none.
"""

from __future__ import annotations

from typing import List, Optional

from pytorch_distributed_tpu_torch.recipes.common import launch


def main(argv: Optional[List[str]] = None, datasets=None) -> dict:
    """Parse ``argv`` and fit; ``datasets`` as ``recipes.common.run`` takes it."""
    return launch(__doc__.splitlines()[0], "fp32", multi_node=False, argv=argv,
                  datasets=datasets)


if __name__ == "__main__":
    main()
