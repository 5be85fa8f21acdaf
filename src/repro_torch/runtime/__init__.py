from .ft import FTConfig, ResilientRunner, RunStats, StepFailure
