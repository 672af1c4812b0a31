"""
The reference learned codec (TwitterDCN, the compressive autoencoder of
Theis et al.) with soft-codebook quantization and the entropy of the
quantized latent.

Encoder: 5x5 stride-2 convs to 64 and 128 channels, three residual blocks of
two 3x3 convs, a 5x5 stride-2 conv to the latent; the input is mapped to
[-1, 1] first. Decoder: 3x3 conv to 512, depth_to_space, three residual
blocks, 3x3 conv to 256, depth_to_space, 3x3 conv to 12, depth_to_space,
(h + 1) / 2 clipped straight-through. Convolutions are TF 'SAME'.

Quantization: the latent times a learned scale; each value's weights over the
codewords are the softmax of -(ν+1)/2 log1p((γ d)²/ν), d the distance to the
codeword (ν 50, γ 25); forward the codeword of largest weight (the first on a
tie), backward the gradient of the weighted mean. The entropy (bits) is that
of the mean weights of the quantized values, clipped at 1e-9 and normalized.

A judged program's codewords can be handed in (``index``): the forward then
takes them in place of its own choice, as a served model's reference reads
the served tokens, and ``code_gap`` says how far each lies from the
reference's own choice (see ``quantize``).
"""
import numpy as np
import torch

from benchmark.reference import ops

RESIDUAL = [f'res{i}_{j}' for i in range(3) for j in (1, 2)]
ENCODER = ['down1', 'down2'] + RESIDUAL + ['to_latent']
DECODER = ['up1'] + RESIDUAL + ['up2', 'up3']


def codebook(bits):
    """The integer codebook {-2^(b-1)+1, ..., 2^(b-1)}."""
    return np.arange(-2 ** (bits - 1) + 1, 2 ** (bits - 1) + 1, dtype=np.float32)


def load(npz_path, device):
    """{name: tensor} of a JAX-format TwitterDCN snapshot, named as
    'encoder.down1.weight' (OIHW), 'encoder.down1.bias', ..., 'latent_scale'."""
    leaves = {}
    with np.load(npz_path) as z:
        for key in z.files:
            parts = key.split('/')
            if parts[-1] == 'kernel':
                parts[-1] = 'weight'
            a = z[key]
            leaves['.'.join(parts)] = (ops.hwio(a, device) if a.ndim == 4 else
                                       torch.as_tensor(a, dtype=torch.float32, device=device))
    return leaves


def _conv(leaves, prefix, name, h, stride=1):
    return ops.conv_same(h, leaves[f'{prefix}.{name}.weight'], leaves[f'{prefix}.{name}.bias'],
                         stride)


def _residual(leaves, prefix, h):
    for i in range(3):
        r = ops.leaky_relu(_conv(leaves, prefix, f'res{i}_1', h))
        h = h + _conv(leaves, prefix, f'res{i}_2', r)
    return h


def encode(x, leaves):
    h = ops.leaky_relu(_conv(leaves, 'encoder', 'down1', 2.0 * (x - 0.5), 2))
    h = ops.leaky_relu(_conv(leaves, 'encoder', 'down2', h, 2))
    return _conv(leaves, 'encoder', 'to_latent', _residual(leaves, 'encoder', h), 2)


def decode(z, leaves):
    h = _residual(leaves, 'decoder', ops.depth_to_space(_conv(leaves, 'decoder', 'up1', z), 2))
    h = ops.depth_to_space(ops.leaky_relu(_conv(leaves, 'decoder', 'up2', h)), 2)
    h = ops.depth_to_space(_conv(leaves, 'decoder', 'up3', h), 2)
    return ops.st_clip((h + 1.0) / 2.0)


def weights(values, cb, v=50.0, gamma=25.0):
    """(N, L) normalized kernel weights of each value against each codeword."""
    d = gamma * (values[:, None] - cb)
    return torch.softmax(-(v + 1.0) / 2.0 * torch.log1p(d * d / v), dim=-1)


def code_gap(z, cb, index):
    """(the widest distance, in codebook units, by which a codeword chosen
    for latent ``z`` (``index``) lies farther from it than the nearest
    codeword does, the number of values whose codeword is not the nearest):
    (0, 0) where each is the nearest; at a near-tie that two evaluations
    decide apart, about twice the latent's round-off."""
    d = (z.reshape(-1, 1).detach() - cb).abs()
    gaps = d.gather(1, index.reshape(-1, 1)) - d.min(dim=1, keepdim=True).values
    return float(gaps.max()), int((gaps > 0).sum())


def quantize(z, cb, v=50.0, gamma=25.0, index=None):
    """(quantized latent, entropy in bits, hard codeword indices, code gap):
    forward the codeword of largest weight, or the codewords ``index`` that
    a judged program chose (their ``code_gap``; (0, 0) without them, an
    infinite gap where they are not one a latent value: the reference then
    takes its own)."""
    flat = z.reshape(-1)
    w = weights(flat, cb, v, gamma)
    soft = w @ cb
    gap = (0.0, 0)
    if index is not None and index.numel() != flat.numel():
        index, gap = None, (float('inf'), flat.numel())
    if index is None:
        index = torch.argmax(w, dim=-1)
    else:
        index = index.reshape(-1).to(flat.device)
        gap = code_gap(flat, cb, index)
    q = (cb[index] - soft).detach() + soft
    hist = torch.clamp(weights(q, cb, v, gamma).mean(dim=0), min=1e-9)
    p = hist / hist.sum()
    entropy = -(p * torch.log(p)).sum() / float(np.log(2.0))
    return q.reshape(z.shape), entropy, index.reshape(z.shape), gap


def codec(x, leaves, bits=5, v=50.0, gamma=25.0, index=None):
    """(decoded batch, entropy, quantized latent, hard indices, code gap) of
    an NCHW batch; ``index``: see ``quantize``."""
    cb = torch.as_tensor(codebook(bits), device=x.device)
    q, entropy, index, gap = quantize(encode(x, leaves) * leaves['latent_scale'], cb, v, gamma,
                                      index)
    return decode(q, leaves), entropy, q, index, gap
