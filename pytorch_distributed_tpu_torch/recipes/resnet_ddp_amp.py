"""ResNet-50, multi-process data parallel in mixed precision (the port of
``recipes/resnet_ddp_amp.py``, the reference's ``resnet_ddp_apex.py``).

``resnet_ddp`` with bf16 compute on fp32 parameters, as the JAX recipe
runs it: bf16 keeps fp32's exponent range, so no loss scaler. fp16 with
the dynamic loss scaler is ``recipes.common.run(args, mesh, "fp16")``
(fp32 compute plus the scaler, the JAX mapping):

    MASTER_IP=... MASTER_PORT=... WORLD_SIZE=<nodes> RANK=<node> \
        python -m pytorch_distributed_tpu_torch.recipes.resnet_ddp_amp --synthetic
    python -m pytorch_distributed_tpu_torch.recipes.resnet_ddp_amp --device cpu --tiny \
        --synthetic --cpu-replicas 2

Without ``--device`` it runs on CUDA and fails where there is none.
"""

from __future__ import annotations

from typing import List, Optional

from pytorch_distributed_tpu_torch.recipes.common import launch


def main(argv: Optional[List[str]] = None, datasets=None) -> dict:
    """Parse ``argv`` and fit; ``datasets`` as ``recipes.common.run`` takes it."""
    return launch(__doc__.splitlines()[0], "bf16", multi_node=True, argv=argv,
                  datasets=datasets)


if __name__ == "__main__":
    main()
