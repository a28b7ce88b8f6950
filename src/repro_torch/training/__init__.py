from .trainer import Trainer, TrainState, make_train_step

__all__ = ["Trainer", "TrainState", "make_train_step"]
