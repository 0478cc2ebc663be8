from pytorch_distributed_tpu_torch.train.lm import (
    check_seq_parallel_attention,
    create_lm_state,
    empty_lm_metrics,
    make_lm_eval_step,
    make_lm_train_step,
    shard_positions,
    shift_labels,
)
from pytorch_distributed_tpu_torch.train.lm_trainer import (
    LMTrainer,
    LMTrainerConfig,
    lm_collate,
    shard_lm_batch,
)
from pytorch_distributed_tpu_torch.train.state import TrainState, create_resnet_state
from pytorch_distributed_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
    prepare_image,
)
from pytorch_distributed_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["LMTrainer", "LMTrainerConfig", "TrainState", "Trainer", "TrainerConfig",
           "check_seq_parallel_attention", "create_lm_state", "create_resnet_state",
           "empty_lm_metrics", "lm_collate", "make_eval_step", "make_lm_eval_step",
           "make_lm_train_step", "make_train_step", "prepare_image", "shard_lm_batch",
           "shard_positions", "shift_labels"]
