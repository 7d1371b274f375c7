from .train_step import TrainState, make_train_step
from .trainer import do_train

__all__ = ["TrainState", "do_train", "make_train_step"]
