from repro_torch.train import checkpoint, fault
from repro_torch.train.trainer import TrainConfig, Trainer, make_train_step

__all__ = ["checkpoint", "fault", "TrainConfig", "Trainer",
           "make_train_step"]
