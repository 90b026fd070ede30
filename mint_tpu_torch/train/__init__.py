"""Training of the port: schedules, the train step, checkpoints, the
controller and the metrics writer (counterparts of ``mint_tpu/train``)."""

from mint_tpu_torch.train import schedules  # noqa: F401
from mint_tpu_torch.train.checkpoint import CheckpointManager  # noqa: F401
from mint_tpu_torch.train.controller import Controller  # noqa: F401
from mint_tpu_torch.train.trainer import Trainer, TrainState  # noqa: F401
