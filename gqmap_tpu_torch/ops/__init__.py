"""Plain PyTorch operators of the port (counterparts of ``gqmap_tpu.ops``)."""
