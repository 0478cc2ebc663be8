"""Entry points of the port: ``python -m pytorch_distributed_tpu_torch.recipes.serve_lm``."""
