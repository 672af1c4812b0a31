"""
The FAN manipulation classifier with a constrained residual first layer.
Port of the float32 path of ``neural_imaging_tpu/models/forensics.py``
(``stem='separate'``); the bf16 FAN and the fused stem are not ported yet.

The constrained filter is renormalized on every forward pass: its off-center
mass is scaled to ``filter_strength`` per output channel and the center tap
pinned to minus that, so the constraint holds exactly throughout training.
"""
import numpy as np
import torch
from torch import nn

from neural_imaging_tpu_torch.models.base import TorchModel, flax_default_init
from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.ops.kernels import center_mask_2dfilter, repeat_2dfilter
from neural_imaging_tpu_torch.utils.paramspec import ParamSpec


class ConstrainedConv(nn.Module):
    """Constrained residual filter, weight (3, 3, 5, 5) OIHW; the input is
    padded symmetrically by 2 and convolved 'VALID'."""

    def __init__(self, filter_strength=100.0):
        super().__init__()
        self.filter_strength = filter_strength
        f = np.array([[0, 0, 0, 0, 0],
                      [0, -1, -2, -1, 0],
                      [0, -2, 12, -2, 0],
                      [0, -1, -2, -1, 0],
                      [0, 0, 0, 0, 0]], dtype=np.float64)
        init = repeat_2dfilter(f, 3).astype(np.float32)
        self.weight = nn.Parameter(ops.hwio_to_oihw(init))
        self.register_buffer('mask', ops.hwio_to_oihw(center_mask_2dfilter(5, 3)),
                             persistent=False)

    def normalized_kernel(self):
        nf = self.weight * (1 - self.mask)
        denom = nf.sum(dim=(1, 2, 3), keepdim=True)      # per output channel
        return self.filter_strength * nf / denom - self.filter_strength * self.mask

    def forward(self, x):
        return ops.conv2d(ops.pad2d(x, 2, 'symmetric'), self.normalized_kernel(),
                          padding='VALID')


class FANCore(nn.Module):
    """Constrained conv → N × [conv 'SAME' + leaky ReLU + 2x2 max-pool] → 1x1
    conv → GAP (or NHWC-order flatten) → dense stack → softmax. NCHW input."""

    def __init__(self, n_classes=7, n_filters=32, n_fscale=2.0, n_convolutions=4,
                 kernel=5, use_gap=False, n_dense=2, activation='leaky_relu',
                 patch_size=None, seed=0):
        super().__init__()
        if not use_gap and patch_size is None:
            raise ValueError('FAN without GAP needs patch_size to size its first dense layer')
        g = torch.Generator().manual_seed(seed)
        self.act = ops.ACTIVATIONS[activation]
        self.use_gap = use_gap
        self.n_convolutions = n_convolutions
        self.n_dense = n_dense
        self.constrained = ConstrainedConv()

        def conv(name, cin, cout, k):
            m = nn.utils.skip_init(nn.Conv2d, cin, cout, k, padding='same')
            setattr(self, name, flax_default_init(m, cin * k * k, g))

        def dense(name, fin, fout):
            m = nn.utils.skip_init(nn.Linear, fin, fout)
            setattr(self, name, flax_default_init(m, fin, g))

        cin, nf = 3, n_filters
        for i in range(n_convolutions):
            conv(f'conv{i}', cin, int(nf), kernel)
            cin, nf = int(nf), int(nf * n_fscale)
        nf = int(nf // n_fscale)
        conv('proj', cin, int(nf), 1)
        features = int(nf)
        if not use_gap:
            side = patch_size // 2 ** n_convolutions
            features *= side * side
        for i in range(n_dense):
            nf = int(nf // n_fscale)
            dense(f'dense{i}', features, nf)
            features = nf
        dense('head', features, n_classes)

    def forward(self, x):
        h = self.constrained(x)
        for i in range(self.n_convolutions):
            h = ops.max_pool(self.act(getattr(self, f'conv{i}')(h)), 2)
        h = self.act(self.proj(h))
        if self.use_gap:
            h = ops.global_average_pool(h)
        else:
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # flax's flatten order
        for i in range(self.n_dense):
            h = self.act(getattr(self, f'dense{i}')(h))
        return torch.softmax(self.head(h), dim=-1)


def sparse_categorical_crossentropy(labels, probabilities):
    """Mean CE over probabilities clipped to [1e-7, 1] (tf.keras parity)."""
    p = ops.clip(probabilities, 1e-7, 1.0)
    return -torch.log(p.gather(-1, labels.long()[:, None])[:, 0]).mean()


class FAN(TorchModel):
    """Forensic analysis network (float32, separate stem).

    ``dropout`` is accepted, as checkpoints record it, but never applied: the
    reference applies it only in the FAN's own ``training_step``, which is
    not ported, while the joint manipulation-classification step runs the
    FAN deterministically (its ``_fan_apply`` calls the FAN with
    ``train=False``)."""

    def __init__(self, n_classes, patch_size=None, n_filters=32, n_fscale=2,
                 n_convolutions=4, kernel=5, dropout=0.0, use_gap=True, n_dense=0,
                 activation='leaky_relu', dtype='float32', stem='separate',
                 constrained_impl='auto', seed=0, device='cuda'):
        if dtype != 'float32' or stem != 'separate':
            raise NotImplementedError(f'FAN dtype={dtype!r} stem={stem!r} is not ported; '
                                      "the port runs dtype='float32', stem='separate'")
        if constrained_impl not in ('auto', 'chw'):
            raise ValueError(f'Unsupported constrained_impl {constrained_impl!r}')
        if activation not in ops.ACTIVATIONS:
            raise ValueError(f'Unsupported activation {activation!r}')
        # the JAX package's spec: its defaults make the logs' repr
        self._h = ParamSpec({
            'n_classes': (7, int), 'n_filters': (32, int), 'n_fscale': (2.0, float),
            'n_convolutions': (4, int), 'kernel': (5, int), 'dropout': (0.0, float),
            'use_gap': (False, bool), 'n_dense': (2, int), 'activation': ('leaky_relu', str),
            'dtype': ('float32', str), 'stem': ('separate', str),
            'constrained_impl': ('auto', str)})
        self._h.update(n_classes=n_classes, n_filters=n_filters, n_fscale=n_fscale,
                       n_convolutions=n_convolutions, kernel=kernel, dropout=dropout,
                       use_gap=use_gap, n_dense=n_dense, activation=activation,
                       dtype=dtype, stem=stem, constrained_impl=constrained_impl)
        self.patch_size = patch_size
        super().__init__(FANCore(n_classes=n_classes, n_filters=n_filters,
                                 n_fscale=n_fscale, n_convolutions=n_convolutions,
                                 kernel=kernel, use_gap=use_gap, n_dense=n_dense,
                                 activation=activation, patch_size=patch_size, seed=seed),
                         device)

    def loss(self, target_labels, class_probabilities):
        """Cross-entropy of the probabilities against integer labels."""
        labels = torch.as_tensor(target_labels, device=class_probabilities.device)
        return sparse_categorical_crossentropy(labels, class_probabilities)

    def process(self, batch_x):
        """Class probabilities of an NHWC image batch (N, h, w, 3)."""
        x = torch.as_tensor(batch_x, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return self.module(x.permute(0, 3, 1, 2))

    def process_and_decide(self, batch_x, with_confidence=False):
        """Predicted class of each image (numpy), and with ``with_confidence``
        the probability of that class."""
        probs = self.process(batch_x).cpu().numpy()
        if with_confidence:
            return probs.argmax(axis=1), probs.max(axis=1)
        return probs.argmax(axis=1)

    def reset_performance_stats(self):
        self.performance = {
            'loss': {'training': [], 'validation': []},
            'accuracy': {'validation': []},
            'confusion': [],
        }

    @property
    def model_code(self):
        h = self._h
        return f'FAN_{h.n_classes}x{h.n_filters}x{h.n_convolutions}C_{h.kernel}x{h.kernel}'

    def summary(self):
        return ('{k}x{k} CNN: 1+{conv}+1 conv layers {gap}+ {fc} fc layers '
                '[{params:,} parameters]').format(
            k=self._h.kernel, conv=self._h.n_convolutions, fc=self._h.n_dense,
            gap='+ (GAP) ' if self._h.use_gap else '', params=self.count_parameters())
