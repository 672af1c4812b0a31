"""
Differentiable rounding modes (round | sin | soft | harmonic | identity).
Port of the non-codebook part of ``neural_imaging_tpu/ops/quantization.py``;
the soft-codebook mode belongs to the DCN slice and is not ported yet.
"""
import math

import torch


def sin_round(x):
    """Differentiable sinusoidal rounding approximation x - sin(2πx)/2π."""
    return x - torch.sin(2 * math.pi * x) / (2 * math.pi)


def quantize(x, rounding='soft', taylor_terms=1):
    """Apply the selected differentiable rounding to x.

    'soft' is hard rounding forward with the gradient of :func:`sin_round`
    (straight-through, detach form). ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    if rounding == 'round':
        return torch.round(x)
    if rounding == 'sin':
        return sin_round(x)
    if rounding == 'soft':
        x_ = sin_round(x)
        return (torch.round(x) - x_).detach() + x_
    if rounding == 'harmonic':
        xa = x - torch.sin(2 * math.pi * x) / math.pi
        for k in range(2, taylor_terms):
            xa = xa + (-1.0) ** k * torch.sin(2 * math.pi * k * x) / (k * math.pi)
        return xa
    if rounding == 'identity':
        return x
    raise ValueError(f'Unsupported quantization: {rounding}')
