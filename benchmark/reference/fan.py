"""
The reference forensic classifier (FAN): a constrained residual 5x5 filter
(off-centre mass scaled to 100 per output channel, centre pinned to -100,
input padded symmetrically by 2), then ``n_convolutions`` × [5x5 'SAME' conv,
leaky ReLU 0.2, 2x2 max-pool] with the width doubling from ``n_filters``, a
1x1 projection with leaky ReLU, global average pooling and a dense head with
softmax. Float32.
"""
import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import ops

STRENGTH = 100.0


def constrained_init():
    """(3, 3, 5, 5) OIHW: the published initial residual filter on each
    channel's diagonal."""
    f = np.array([[0, 0, 0, 0, 0], [0, -1, -2, -1, 0], [0, -2, 12, -2, 0],
                  [0, -1, -2, -1, 0], [0, 0, 0, 0, 0]], np.float32)
    w = np.zeros((3, 3, 5, 5), np.float32)
    for c in range(3):
        w[c, c] = f
    return w


def leaf_shapes(n_classes, n_filters=32, n_fscale=2.0, n_convolutions=4, kernel=5, **_):
    """{name: shape} of the FAN's leaves (GAP, no dense layers), OIHW and (out, in)."""
    shapes = {'constrained.weight': (3, 3, 5, 5)}
    cin, nf = 3, n_filters
    for i in range(n_convolutions):
        shapes[f'conv{i}.weight'] = (int(nf), cin, kernel, kernel)
        shapes[f'conv{i}.bias'] = (int(nf),)
        cin, nf = int(nf), int(nf * n_fscale)
    nf = int(nf // n_fscale)
    shapes['proj.weight'] = (nf, cin, 1, 1)
    shapes['proj.bias'] = (nf,)
    shapes['head.weight'] = (n_classes, nf)
    shapes['head.bias'] = (n_classes,)
    return shapes


def draw(shapes, generator, device):
    """Leaves from one standard-normal draw on ``device``
    (``ops.lecun_draw``: each kernel LeCun-normal, each bias 0), the
    constrained filter its published initial value."""
    leaves = ops.lecun_draw({k: v for k, v in shapes.items() if k != 'constrained.weight'},
                            generator, device)
    leaves['constrained.weight'] = torch.as_tensor(constrained_init(), device=device)
    return {k: leaves[k] for k in shapes}


def fan(x, leaves, n_convolutions=4, **_):
    """Class probabilities of an NCHW RGB batch."""
    w = leaves['constrained.weight']
    mask = torch.zeros_like(w)
    for c in range(3):
        mask[c, c, 2, 2] = 1
    off = w * (1 - mask)
    k = STRENGTH * off / off.sum(dim=(1, 2, 3), keepdim=True) - STRENGTH * mask
    h = F.conv2d(ops.pad_symmetric(x, 2), k)
    for i in range(n_convolutions):
        h = ops.conv_same(h, leaves[f'conv{i}.weight'], leaves[f'conv{i}.bias'])
        h = F.max_pool2d(ops.leaky_relu(h), 2)
    h = ops.leaky_relu(F.conv2d(h, leaves['proj.weight'], leaves['proj.bias']))
    logits = F.linear(h.mean(dim=(-2, -1)), leaves['head.weight'], leaves['head.bias'])
    return torch.softmax(logits, dim=-1)


def cross_entropy(probs, labels):
    """Mean -log p of the labels, p clipped to [1e-7, 1] (jnp.clip's gradient)."""
    p = ops.clip(probs, 1e-7, 1.0)
    return -torch.log(p.gather(1, labels[:, None])[:, 0]).mean()
