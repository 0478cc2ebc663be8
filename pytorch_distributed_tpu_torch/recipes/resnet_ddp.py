"""ResNet-50, multi-process data parallel over nodes (the port of
``recipes/resnet_ddp.py``, the reference's ``restnet_ddp.py``).

Each node runs this with the reference's environment contract and spawns
a rank a visible card; the ranks meet over NCCL, average their gradients
and their BatchNorm statistics each step, and sample the data by node:

    MASTER_IP=... MASTER_PORT=... WORLD_SIZE=<nodes> RANK=<node> \
        python -m pytorch_distributed_tpu_torch.recipes.resnet_ddp --synthetic
    python -m pytorch_distributed_tpu_torch.recipes.resnet_ddp --data-dir D --raw --raw-aug crop

Without ``MASTER_IP``/``MASTER_PORT`` it runs on this node's cards (the
DDP recipe, a world of one node). fp32, the reference's hyperparameters
(``recipes.common.run``). On the CPU: ``--device cpu --tiny --synthetic
--cpu-replicas 2``. Without ``--device`` it runs on CUDA and fails where
there is none.
"""

from __future__ import annotations

from typing import List, Optional

from pytorch_distributed_tpu_torch.recipes.common import launch


def main(argv: Optional[List[str]] = None, datasets=None) -> dict:
    """Parse ``argv`` and fit; ``datasets`` as ``recipes.common.run`` takes it."""
    return launch(__doc__.splitlines()[0], "fp32", multi_node=True, argv=argv,
                  datasets=datasets)


if __name__ == "__main__":
    main()
