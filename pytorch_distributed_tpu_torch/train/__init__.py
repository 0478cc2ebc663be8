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
from pytorch_distributed_tpu_torch.train.state import TrainState, create_resnet_state
from pytorch_distributed_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
    prepare_image,
)
from pytorch_distributed_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["LMTrainer", "LMTrainerConfig", "TrainState", "Trainer", "TrainerConfig",
           "create_lm_state", "create_resnet_state", "empty_lm_metrics", "lm_collate",
           "make_eval_step", "make_lm_eval_step", "make_lm_train_step", "make_train_step",
           "prepare_image", "shift_labels"]
