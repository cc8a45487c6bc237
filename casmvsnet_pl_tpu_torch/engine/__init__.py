from .trainer import MVSTrainer, TrainState, model_batch_args

__all__ = ["MVSTrainer", "TrainState", "model_batch_args"]
