from .manager import CheckpointConfig, CheckpointManager
