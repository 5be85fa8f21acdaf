from .pipeline import DataConfig, ShardedTokenPipeline
