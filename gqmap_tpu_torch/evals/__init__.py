"""Evaluation helpers of the port (counterparts of ``gqmap_tpu.evals``)."""

from .metrics import MetricsLogger, aepe
