"""
Plain PyTorch building blocks of the reference flows, on NCHW float tensors.

Written from the published operations (TF 'SAME' convolutions, TF-order
depth_to_space, jnp.clip's gradient, jax's leaky ReLU), not from the
program: this package imports nothing of the port, of JAX or of the JAX
package. Every function runs in the dtype it is given; the caller fixes the
precision of convolutions and matrix products (``precision``).
"""
import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(tf32):
    """float32 products in full float32 (``tf32`` False, what the
    configurations state) or in TF32 (the lower-precision control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def lecun_draw(shapes, generator, device):
    """Leaves {name: tensor} of ``shapes`` from one standard-normal draw on
    ``device``, in the order of ``shapes``: each leaf of two or more axes
    LeCun-normal (std 1/√fan_in, fan_in all axes but the first), each
    one-axis leaf 0."""
    kernels = [k for k, shape in shapes.items() if len(shape) > 1]
    sizes = [int(np.prod(shapes[k])) for k in kernels]
    z = torch.randn(sum(sizes), generator=generator, device=device)
    leaves, start = {}, 0
    for k, size in zip(kernels, sizes):
        shape = shapes[k]
        leaves[k] = z[start:start + size].reshape(shape) / float(np.prod(shape[1:])) ** 0.5
        start += size
    for k, shape in shapes.items():
        if len(shape) == 1:
            leaves[k] = torch.zeros(shape, device=device)
    return {k: leaves[k].contiguous() for k in shapes}


def hwio(kernel, device):
    """An HWIO numpy kernel as an OIHW float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(kernel, np.float32)).permute(3, 2, 0, 1).contiguous().to(
        device)


def same_pads(size, k, stride):
    """TF 'SAME' zero padding (low, high) of one axis."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x, w, bias=None, stride=1):
    """TF 'SAME' convolution of NCHW ``x`` with OIHW ``w``."""
    top, bottom = same_pads(x.shape[-2], w.shape[-2], stride)
    left, right = same_pads(x.shape[-1], w.shape[-1], stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, bias, stride)


def pad_symmetric(x, p):
    """numpy's 'symmetric' padding (edge sample repeated) of H and W."""
    x = torch.cat([x[..., :p, :].flip(-2), x, x[..., -p:, :].flip(-2)], dim=-2)
    return torch.cat([x[..., :p].flip(-1), x, x[..., -p:].flip(-1)], dim=-1)


def depthwise(x, k, mode):
    """Per-channel 'SAME' filter: ``k`` (kh, kw, C) float32, padded ``mode``
    ('reflect' or 'symmetric')."""
    c, p = x.shape[1], (k.shape[0] - 1) // 2
    xp = F.pad(x, (p, p, p, p), mode='reflect') if mode == 'reflect' else pad_symmetric(x, p)
    return F.conv2d(xp, k.permute(2, 0, 1)[:, None].to(x), groups=c)


def depth_to_space(x, block=2):
    """TF-order depth_to_space: channel (i*b + j)*C + c → sub-pixel (i, j)."""
    n, c, h, w = x.shape
    cc = c // (block * block)
    x = x.reshape(n, block, block, cc, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, cc, h * block, w * block)


def clip(x, lo, hi):
    """jnp.clip: gradient 1 inside, 0 outside, 1/2 at a bound."""
    return torch.minimum(torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device)),
                         torch.full((), hi, dtype=x.dtype, device=x.device))


def st_clip(x):
    """Clip to [0, 1] forward, identity gradient."""
    return (torch.clamp(x, 0.0, 1.0) - x).detach() + x


def leaky_relu(x, slope=0.2):
    """jax's leaky ReLU: slope 0.2, derivative 1 at 0."""
    return torch.where(x >= 0, x, slope * x)


def soft_round(x):
    """Round half to even forward, the derivative of x - sin(2πx)/2π backward."""
    smooth = x - torch.sin(2 * np.pi * x) / (2 * np.pi)
    return (torch.round(x) - smooth).detach() + smooth


class Adam:
    """Adam (β 0.9, 0.999, ε 1e-8, no decay) over a dict of leaves, as
    ``p -= lr m̂ / (√v̂ + ε)``."""

    def __init__(self, leaves, lr):
        self.leaves, self.lr, self.t = leaves, lr, 0
        self.m = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.v = {k: torch.zeros_like(p) for k, p in leaves.items()}

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in self.leaves.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr / c1 * self.m[k] / (self.v[k].sqrt() / c2 ** 0.5 + 1e-8))
