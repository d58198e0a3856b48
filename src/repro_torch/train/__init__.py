from repro_torch.train.trainer import Trainer, TrainResult

__all__ = ["Trainer", "TrainResult"]
