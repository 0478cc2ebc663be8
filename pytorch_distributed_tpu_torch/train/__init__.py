from pytorch_distributed_tpu_torch.train.lm import (
    create_lm_state,
    empty_lm_metrics,
    make_lm_eval_step,
    make_lm_train_step,
    shift_labels,
)
from pytorch_distributed_tpu_torch.train.lm_trainer import (
    LMTrainer,
    LMTrainerConfig,
    lm_collate,
)
from pytorch_distributed_tpu_torch.train.state import TrainState

__all__ = ["LMTrainer", "LMTrainerConfig", "TrainState", "create_lm_state",
           "empty_lm_metrics", "lm_collate", "make_lm_eval_step",
           "make_lm_train_step", "shift_labels"]
