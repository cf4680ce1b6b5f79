from .metrics import Metrics, StageTimer, metrics  # noqa: F401
