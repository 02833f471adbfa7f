"""The GQMAP engine of the port (counterpart of ``gqmap_tpu.models``)."""
