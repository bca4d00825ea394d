"""Training (port of ``millieye_tpu/train``): the optimizer, the three
train steps, the trainer and its recipes, and the metrics logger."""
from millieye_torch.train.optim import (
    label_tree,
    frozen_adam,
    STAGE3_FROZEN,
)
from millieye_torch.train.steps import (
    make_yolo_train_step,
    make_refine_train_step,
    make_fusion_train_step,
    TrainState,
)
from millieye_torch.train.recipes import (
    Trainer,
    yolo_trainer,
    refine_trainer,
    fusion_trainer,
    fusion_device_batch,
)
from millieye_torch.train.logging import MetricsLogger
