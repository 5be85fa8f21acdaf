from .elastic import factor_mesh, remesh_plan
from .ft import FTConfig, ResilientRunner, RunStats, StepFailure
