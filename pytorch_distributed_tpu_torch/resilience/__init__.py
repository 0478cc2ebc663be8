from pytorch_distributed_tpu_torch.resilience.stepguard import finite_ok, guarded_step

__all__ = ["finite_ok", "guarded_step"]
