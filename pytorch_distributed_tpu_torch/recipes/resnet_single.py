"""ResNet-50 on one card (the port of ``recipes/resnet_single.py``).

fp32, SGD(0.1, momentum 0.9, weight decay 1e-4), StepLR(30, 0.1), 100
epochs at batch 400 and a validation pass per epoch, through ``Trainer``:

    python -m pytorch_distributed_tpu_torch.recipes.resnet_single --synthetic
    python -m pytorch_distributed_tpu_torch.recipes.resnet_single --data-dir D --raw --raw-aug crop
    python -m pytorch_distributed_tpu_torch.recipes.resnet_single --device cpu --tiny --synthetic

Without ``--device`` it runs on CUDA and fails where there is none.
"""

from __future__ import annotations

from typing import List, Optional

from pytorch_distributed_tpu_torch.recipes.common import parse_args, run


def main(argv: Optional[List[str]] = None, datasets=None) -> dict:
    """Parse ``argv`` and fit; ``datasets`` as ``recipes.common.run`` takes it."""
    return run(parse_args(__doc__.splitlines()[0], argv), precision="fp32", datasets=datasets)


if __name__ == "__main__":
    main()
