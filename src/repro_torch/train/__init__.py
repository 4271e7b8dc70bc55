"""Port of ``repro.train``: the training step and its loop."""

from repro_torch.train.trainer import Trainer, TrainState, make_train_step

__all__ = ["TrainState", "Trainer", "make_train_step"]
