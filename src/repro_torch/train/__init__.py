from repro_torch.train.trainer import StepTimeMonitor, Trainer, TrainResult

__all__ = ["StepTimeMonitor", "Trainer", "TrainResult"]
