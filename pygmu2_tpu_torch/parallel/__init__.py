"""Multi-device rendering (counterpart of ``pygmu2_tpu.parallel``): see
:mod:`pygmu2_tpu_torch.parallel.render`."""
