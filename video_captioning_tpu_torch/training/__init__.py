from .losses import label_smoothed_cross_entropy  # noqa: F401
from .optim import PlateauScheduler, build_optimizer, lr_at_epoch  # noqa: F401
from .trainer import VideoCaptioningTrainer  # noqa: F401
