"""Numerical primitives of the PyTorch port (counterpart of ``pygmu2_tpu.ops``)."""
