"""
The FAN manipulation classifier with a constrained residual first layer.
Port of ``neural_imaging_tpu/models/forensics.py``: float32 or bfloat16
compute, the separate or the fused stem.

The constrained filter is renormalized on every forward pass: its off-center
mass is scaled to ``filter_strength`` per output channel and the center tap
pinned to minus that, so the constraint holds exactly throughout training.

``dtype='bfloat16'`` has flax's ``nn.Conv``/``nn.Dense(dtype=bfloat16)``
semantics: the weights stay float32 parameters (Adam updates them in
float32) and are cast to bfloat16 for each use; each conv and matrix product
sums in float32 and rounds its result to bfloat16, and only then is the
bfloat16 bias added (one more rounding); activations and max-pools run in
bfloat16, and the softmax takes the logits in float32.

Dropout (flax's ``nn.Dropout``) follows each dense layer's activation in
training only, in the FAN's own :meth:`FAN.training_step`: each value is
kept with probability 1 − rate and scaled by 1 / (1 − rate), or zeroed. The
masks come from the FAN's ``torch.Generator`` or from the caller (flax's and
torch's random streams differ). The joint manipulation-classification step
runs the FAN without dropout, as the reference's does.

The initial weights from ``seed`` are the reference's from ``PRNGKey(seed)``
(``utils/prng.py``: flax's LeCun-normal draw of each layer, its key folded
from the layer's name), so the two packages' runs start from one model.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neural_imaging_tpu_torch.models.base import TorchModel, flax_default_init
from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.ops.kernels import center_mask_2dfilter, repeat_2dfilter
from neural_imaging_tpu_torch.utils import prng
from neural_imaging_tpu_torch.utils.paramspec import ParamSpec


DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class ConstrainedConv(nn.Module):
    """Constrained residual filter, weight (3, 3, 5, 5) OIHW; the input is
    padded symmetrically by 2 and convolved 'VALID'. The kernel is
    renormalized in float32. float32: one float32 conv, its result rounded
    to the input's dtype (the reference's exact-f32 conv keeps the input's
    dtype); bfloat16: one bfloat16 conv."""

    def __init__(self, filter_strength=100.0, dtype=torch.float32):
        super().__init__()
        self.filter_strength = filter_strength
        self.compute_dtype = dtype
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
        nf = self.normalized_kernel()
        if self.compute_dtype == torch.bfloat16:
            return ops.conv2d(ops.pad2d(x.to(torch.bfloat16), 2, 'symmetric'), nf,
                              padding='VALID')
        return ops.conv2d(ops.pad2d(x.to(torch.float32), 2, 'symmetric'), nf,
                          padding='VALID').to(x.dtype)


def compose_conv_kernels(k1, k2):
    """OIHW (m, ci, k, k) then (co, m, l, l) → (co, ci, k+l-1, k+l-1): the
    single kernel whose 'VALID' correlation equals 'VALID'(k2) ∘ 'VALID'(k1),
    the full convolution of the two summed over m, computed as one float32
    conv (differentiable in both)."""
    pad = k2.shape[-1] - 1
    stack = F.pad(k1.permute(1, 0, 2, 3), (pad, pad, pad, pad))     # (ci, m, …)
    return F.conv2d(stack, k2.flip(-2, -1)).permute(1, 0, 2, 3)


class FANCore(nn.Module):
    """Constrained conv → N × [conv 'SAME' + leaky ReLU + 2x2 max-pool] → 1x1
    conv → GAP (or NHWC-order flatten) → dense stack → softmax. NCHW input.

    ``stem='fused'`` composes the constrained filter with conv0 into one
    (k+4)x(k+4) conv of the input padded symmetrically by 2 and then with
    zeros (``compose_conv_kernels``); interior pixels equal the separate
    stem's, the 2-px border differs, so the stem is part of a trained model."""

    def __init__(self, n_classes=7, n_filters=32, n_fscale=2.0, n_convolutions=4,
                 kernel=5, use_gap=False, n_dense=2, activation='leaky_relu',
                 patch_size=None, seed=0, dtype=torch.float32, stem='separate', dropout=0.0):
        super().__init__()
        if not use_gap and patch_size is None:
            raise ValueError('FAN without GAP needs patch_size to size its first dense layer')
        if stem == 'fused' and n_convolutions < 1:
            raise ValueError("stem='fused' requires n_convolutions >= 1")
        self.act = ops.ACTIVATIONS[activation]
        self.use_gap = use_gap
        self.n_convolutions = n_convolutions
        self.n_dense = n_dense
        self.dropout = dropout
        self.compute_dtype = dtype
        self.stem = stem
        self.constrained = ConstrainedConv(dtype=dtype)

        root = prng.prng_key(seed)

        def conv(name, cin, cout, k):
            setattr(self, name, flax_default_init(
                nn.utils.skip_init(nn.Conv2d, cin, cout, k, padding='same'),
                prng.flax_param_key(root, name)))

        def dense(name, fin, fout):
            setattr(self, name, flax_default_init(nn.utils.skip_init(nn.Linear, fin, fout),
                                                  prng.flax_param_key(root, name)))

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

    def _conv(self, layer, h):
        if self.compute_dtype == torch.float32:
            return layer(h)
        bf16 = torch.bfloat16
        return (F.conv2d(h, layer.weight.to(bf16), None, padding=layer.padding)
                + layer.bias.to(bf16)[:, None, None])

    def _dense(self, layer, h):
        if self.compute_dtype == torch.float32:
            return layer(h)
        return F.linear(h, layer.weight.to(torch.bfloat16)) + layer.bias.to(torch.bfloat16)

    def _fused_stem(self, x):
        """The constrained filter and conv0 as one conv, then conv0's bias
        (added in float32 and rounded once, as the reference adds it),
        the activation and the max-pool."""
        kc = compose_conv_kernels(self.constrained.normalized_kernel(), self.conv0.weight)
        r = (self.conv0.weight.shape[-1] - 1) // 2
        xp = ops.pad2d(ops.pad2d(x.to(self.compute_dtype), 2, 'symmetric'), r, 'constant')
        h = ops.conv2d(xp, kc, padding='VALID')
        h = (h.to(torch.float32) + self.conv0.bias[:, None, None]).to(self.compute_dtype)
        return ops.max_pool(self.act(h), 2)

    def dropout_shapes(self, batch):
        """The shapes of the dropout masks of a batch: one per dense layer."""
        return [(batch, getattr(self, f'dense{i}').out_features) for i in range(self.n_dense)]

    def _dropout(self, h, mask):
        keep = 1.0 - self.dropout
        return torch.where(mask, h / ops.scalar(keep, h.dtype, h.device), torch.zeros_like(h))

    def forward(self, x, dropout_masks=None):
        """Class probabilities of an NCHW batch; with ``dropout_masks`` (one
        boolean mask a dense layer, ``dropout_shapes``) dropout is applied
        after each dense layer."""
        if self.stem == 'fused':
            h, start = self._fused_stem(x), 1
        else:
            h, start = self.constrained(x).to(self.compute_dtype), 0
        for i in range(start, self.n_convolutions):
            h = ops.max_pool(self.act(self._conv(getattr(self, f'conv{i}'), h)), 2)
        h = self.act(self._conv(self.proj, h))
        if self.use_gap:
            # jnp.mean of bfloat16 sums and divides in float32, rounds once
            h = ops.global_average_pool(h.to(torch.float32)).to(self.compute_dtype)
        else:
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # flax's flatten order
        for i in range(self.n_dense):
            h = self.act(self._dense(getattr(self, f'dense{i}'), h))
            if dropout_masks is not None and self.dropout > 0:
                h = self._dropout(h, dropout_masks[i])
        return torch.softmax(self._dense(self.head, h).to(torch.float32), dim=-1)


def sparse_categorical_crossentropy(labels, probabilities):
    """Mean CE over probabilities clipped to [1e-7, 1] (tf.keras parity)."""
    p = ops.clip(probabilities, 1e-7, 1.0)
    return -torch.log(p.gather(-1, labels.long()[:, None])[:, 0]).mean()


# the seed of the FAN's dropout masks, as the reference seeds its dropout key
DROPOUT_SEED = 17


class FAN(TorchModel):
    """Forensic analysis network (float32 or bfloat16, separate or fused stem).

    ``dropout`` applies only in :meth:`training_step`, as in the reference,
    whose joint manipulation-classification step calls the FAN with
    ``train=False``."""

    def __init__(self, n_classes, patch_size=None, n_filters=32, n_fscale=2,
                 n_convolutions=4, kernel=5, dropout=0.0, use_gap=True, n_dense=0,
                 activation='leaky_relu', dtype='float32', stem='separate',
                 constrained_impl='auto', seed=0, device='cuda'):
        if dtype not in DTYPES:
            raise ValueError(f'Unsupported FAN dtype {dtype!r}; use one of {list(DTYPES)}')
        if stem not in ('separate', 'fused'):
            raise ValueError(f'Unsupported FAN stem {stem!r}')
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
                                 activation=activation, patch_size=patch_size, seed=seed,
                                 dtype=DTYPES[dtype], stem=stem, dropout=dropout),
                         device)
        self._dropout_generator = None
        self.init_optimizer()

    def init_optimizer(self):
        """(Re)start Adam (optax's ``scale_by_adam`` defaults) of
        :meth:`training_step`; the learning rate is set at each step."""
        self.optimizer = torch.optim.Adam(self.module.parameters(), lr=1e-4, betas=(0.9, 0.999),
                                          eps=1e-8)

    def loss(self, target_labels, class_probabilities):
        """Cross-entropy of the probabilities against integer labels."""
        labels = torch.as_tensor(target_labels, device=class_probabilities.device)
        return sparse_categorical_crossentropy(labels, class_probabilities)

    def process(self, batch_x):
        """Class probabilities of an NHWC image batch (N, h, w, 3): a
        bfloat16 tensor as it is (a bfloat16 channel's output), anything
        else as float32."""
        x = torch.as_tensor(batch_x, device=self.device)
        x = x if x.dtype == torch.bfloat16 else x.to(torch.float32)
        with torch.no_grad():
            return self.module(x.permute(0, 3, 1, 2))

    def serve(self, x):
        """The JAX model's ``_apply``: class probabilities of an NHWC batch."""
        return self.module(x.permute(0, 3, 1, 2))

    def training_step(self, batch_x, target_labels, learning_rate=None, dropout_mask=None):
        """One Adam step of the FAN alone on an NHWC image batch and its
        integer labels, with dropout (``dropout`` > 0) after each dense layer:
        the masks ``dropout_mask`` (one boolean (batch, features) array a
        dense layer) or, without them, fresh ones from the FAN's generator
        (seeded ``DROPOUT_SEED``). Returns the cross-entropy, a 0-d tensor on
        the device, from the forward pass before the update."""
        x = torch.as_tensor(batch_x, dtype=torch.float32, device=self.device).permute(0, 3, 1, 2)
        labels = torch.as_tensor(np.asarray(target_labels), device=self.device)
        masks = None
        if self._h.dropout > 0:
            if dropout_mask is not None:
                masks = [torch.as_tensor(np.array(m, dtype=bool), device=self.device)
                         for m in dropout_mask]
            else:
                if self._dropout_generator is None:
                    self._dropout_generator = torch.Generator(self.device).manual_seed(
                        DROPOUT_SEED)
                keep = 1.0 - self._h.dropout
                masks = [torch.rand(shape, generator=self._dropout_generator,
                                    device=self.device) < keep
                         for shape in self.module.dropout_shapes(x.shape[0])]
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(labels, self.module(x, dropout_masks=masks))
        loss.backward()
        for group in self.optimizer.param_groups:
            group['lr'] = 1e-4 if learning_rate is None else float(learning_rate)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss.detach()

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
