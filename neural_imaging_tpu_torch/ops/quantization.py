"""
Differentiable rounding modes (round | sin | soft | harmonic | identity |
soft-codebook) and the soft-histogram entropy estimator. Port of
``neural_imaging_tpu/ops/quantization.py``.

The soft-codebook functions here are the plain composition: they build the
(N, L) weight matrix of every value against every codeword, as the
reference's XLA form does. The DCN runs the fused kernels of
``ops/hopper/codebook.py`` instead, which never build it; this composition is
what they are held against.
"""
import math

import numpy as np
import torch

from neural_imaging_tpu_torch.ops import ops

LN2 = float(np.log(2.0))


def sin_round(x):
    """Differentiable sinusoidal rounding approximation x - sin(2πx)/2π, with
    2π rounded to x's dtype as the reference's constant is."""
    two_pi = ops.const(2 * math.pi, x.dtype)
    return x - torch.sin(two_pi * x) / ops.scalar(two_pi, x.dtype, x.device)


def default_codebook(latent_bpf):
    """Integer codebook {-2^(b-1)+1, ..., 2^(b-1)} with 2^b entries (numpy float32)."""
    qmin = -2 ** (latent_bpf - 1) + 1
    qmax = 2 ** (latent_bpf - 1)
    return np.arange(qmin, qmax + 1, dtype=np.float32)


def codebook_log_weights(x, codebook, v=50.0, gamma=25.0):
    """Log kernel weights of each value against each codeword, shape (..., L).
    v <= 0 selects the Gaussian kernel, otherwise a t-Student kernel with v
    degrees of freedom."""
    d = x[..., None] - codebook
    if v <= 0:
        return -gamma * torch.square(d)
    dd = gamma * d
    return -(v + 1.0) / 2.0 * torch.log1p(torch.square(dd) / v)


def _int_power(t, n):
    """t**n for a positive integer n by repeated squaring."""
    result = None
    square = t
    while n:
        if n & 1:
            result = square if result is None else result * square
        square = square * square
        n >>= 1
    return result


def codebook_weights(x, codebook, v=50.0, gamma=25.0):
    """Normalized kernel weights, shape (..., L).

    For an integer t-Student ν with ν + 1 <= 128 (the default ν = 50) the
    unnormalized weight (1 + (γd)²/ν)^(-(ν+1)/2) is rsqrt(t^(ν+1)) by repeated
    squaring, with t divided by its row minimum (so the largest weight is
    exactly 1) and clamped below the float32 overflow of t^(ν+1). Other
    kernels take the log-space softmax."""
    if v > 0 and float(v).is_integer() and int(v) + 1 <= 128:
        d = gamma * (x[..., None] - codebook)
        t = 1.0 + d * d / v
        t = t / torch.amin(t, dim=-1, keepdim=True)
        t_max = 0.9 * float(3.0e38 ** (1.0 / (int(v) + 1)))
        t = torch.clamp(t, max=t_max)
        w = torch.rsqrt(_int_power(t, int(v) + 1))
        return w / torch.sum(w, dim=-1, keepdim=True)
    return torch.softmax(codebook_log_weights(x, codebook, v, gamma), dim=-1)


def quantize(x, rounding='soft', codebook=None, v=50.0, gamma=25.0, taylor_terms=1):
    """Apply the selected differentiable rounding to x.

    'soft' is hard rounding forward with the gradient of :func:`sin_round`
    (straight-through, detach form). A bfloat16 x stays bfloat16, each
    operation rounding as the reference's does. ``torch.round`` rounds half to even, as
    ``jnp.round`` does. 'soft-codebook' is the nearest codeword by kernel
    weight forward (the first one on a tie, as ``argmax`` takes it) with the
    gradient of the weighted codeword mean."""
    if rounding == 'round':
        return torch.round(x)
    if rounding == 'sin':
        return sin_round(x)
    if rounding == 'soft':
        x_ = sin_round(x)
        return (torch.round(x) - x_).detach() + x_
    if rounding == 'harmonic':
        def term(k):
            # sin(2πk x) / (kπ), its constants rounded to x's dtype
            c = ops.const(2 * math.pi * k, x.dtype)
            return torch.sin(c * x) / ops.scalar(ops.const(k * math.pi, x.dtype), x.dtype,
                                                 x.device)
        xa = x - term(1)
        for k in range(2, taylor_terms):
            xa = xa + (-1.0) ** k * term(k)
        return xa
    if rounding == 'identity':
        return x
    if rounding == 'soft-codebook':
        if codebook is None:
            raise ValueError('soft-codebook rounding requires a codebook')
        codebook = torch.as_tensor(codebook, dtype=x.dtype, device=x.device).reshape(-1)
        w = codebook_weights(x, codebook, v, gamma)
        soft = torch.einsum('...l,l->...', w, codebook)
        hard = codebook[torch.argmax(w, dim=-1)]
        return (hard - soft).detach() + soft
    raise ValueError(f'Unsupported quantization: {rounding}')


def entropy(values, codebook, v=50.0, gamma=25.0):
    """Differentiable entropy (bits) of values quantized against a codebook: a
    soft histogram from the kernel weights, then H = -Σ p log2 p.
    Returns (entropy, histogram)."""
    codebook = torch.as_tensor(codebook, dtype=values.dtype,
                               device=values.device).reshape(-1)
    w = codebook_weights(values.reshape(-1), codebook, v, gamma)
    histogram = torch.clamp(torch.mean(w, dim=0), min=1e-9)
    histogram = histogram / torch.sum(histogram)
    h = -torch.sum(histogram * torch.log(histogram)) / LN2
    return h, histogram


def quantize_with_entropy(x, codebook, rounding='soft-codebook', v=50.0, gamma=25.0):
    """Quantization, then the entropy estimate of the quantized latent (the
    straight-through value makes the histogram sharp; gradients flow through
    the soft branch into both terms). Returns (quantized, entropy_bits,
    histogram)."""
    codebook = torch.as_tensor(codebook, dtype=x.dtype, device=x.device).reshape(-1)
    q = quantize(x, rounding, codebook, v, gamma)
    h, histogram = entropy(q, codebook, v, gamma)
    return q, h, histogram
