"""Ops on NCHW tensors: ports of neural_imaging_tpu/ops/ (modules are imported one by one)."""
