"""``incubate``: the auto-checkpoint epoch range."""

from . import auto_checkpoint  # noqa: F401
from .auto_checkpoint import TrainEpochRange, train_epoch_range  # noqa: F401
