"""Run utilities of the port (counterparts of ``gqmap_tpu.utils``)."""

from .checkpoint import load_checkpoint, save_checkpoint
