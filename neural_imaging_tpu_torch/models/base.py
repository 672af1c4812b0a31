"""
Model shell and checkpoint I/O in the JAX package's format.

A checkpoint is ``<dir>/<class>.npz`` of flax parameter paths (``conv0/kernel``,
``head/bias``, …) with HWIO conv kernels and Dense kernels of shape (in, out).
:func:`convert_params` turns such a file into a PyTorch ``state_dict``; that is
how weights trained by the JAX package are carried into the port.
"""
import os

import numpy as np
import torch

from neural_imaging_tpu_torch.utils.device import resolve_device


def load_flax_npz(filename):
    """{flax path: array} of a JAX-format ``.npz`` checkpoint."""
    with np.load(filename) as z:
        return {k: z[k] for k in z.files}


def convert_params(flax_flat):
    """Flat flax parameters → PyTorch ``state_dict``.

    Paths map '/' → '.', and a last component 'kernel' becomes 'weight'.
    Every 4-D array is an HWIO conv kernel and becomes OIHW; every 2-D array
    is a Dense kernel (in, out) and becomes (out, in); other arrays pass
    unchanged. Values are float32 tensors on the CPU."""
    state = {}
    for path, value in flax_flat.items():
        parts = path.split('/')
        if parts[-1] == 'kernel':
            parts[-1] = 'weight'
        t = torch.tensor(np.asarray(value, dtype=np.float32))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        elif t.ndim == 2:
            t = t.T
        state['.'.join(parts)] = t.contiguous()
    return state


class TorchModel:
    """Shell around an ``nn.Module`` core: device placement, naming and
    loading of JAX-format checkpoints. The core runs in eval mode."""

    def __init__(self, module, device='cuda'):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()

    @property
    def class_name(self):
        return type(self).__name__

    @property
    def scoped_name(self):
        return type(self).__name__.lower()

    def load_model(self, dirname):
        """Load ``<dirname>[/<scoped name>]/<class>.npz`` (strict: every
        parameter present, no extra ones)."""
        if not dirname.rstrip('/').endswith(self.scoped_name):
            dirname = os.path.join(dirname, self.scoped_name)
        filename = os.path.join(dirname, f'{self.class_name.lower()}.npz')
        self.module.load_state_dict(convert_params(load_flax_npz(filename)), strict=True)

    def count_parameters(self):
        return sum(p.numel() for p in self.module.parameters())
