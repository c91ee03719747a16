from maxk_gnn.train.config import TrainConfig, parse_args
from maxk_gnn.train.loop import train, evaluate
from maxk_gnn.train.metrics import accuracy, compute_micro_f1

__all__ = [
    "TrainConfig",
    "parse_args",
    "train",
    "evaluate",
    "accuracy",
    "compute_micro_f1",
]
