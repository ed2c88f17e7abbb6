from .trainer import Trainer, TrainConfig, pad_batch, loss_and_metrics
from . import checkpoint, dataset, embedding_bridge
