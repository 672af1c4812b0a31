"""
Camera ISP models (NIPs): INet, UNet, DNet, ONet and ClassicISP. Port of
``neural_imaging_tpu/models/pipelines.py``: the cores are ``nn.Module``s
on NCHW tensors, the shells (``NIPModel`` and its subclasses) take and give
NHWC batches, as the reference's do.

Every model but ONet consumes RGGB Bayer stacks in [0,1] and emits RGB at
twice the size, clipped with a straight-through estimator (ClassicISP: a
stop-gradient clip to [1/255, 1] and gamma 1/2.2). ``NIPModel.training_step``
is one Adam step of the fidelity loss (optax's ``scale_by_adam`` then
−lr·u, as the reference's ``TPUModel``), normalizing quantized batches in
the step.

UNet's and DNet's ``dtype='bfloat16'`` has flax's ``nn.Conv(dtype=...)``
semantics: the weights stay float32 parameters and are cast to bfloat16 for
each use; a conv sums in float32 and rounds its result to bfloat16, and only
then is the bfloat16 bias added; activations, pools and pads run in
bfloat16, and the output is taken to float32 before depth_to_space.
"""
import ast
import json
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neural_imaging_tpu_torch.data import bayer as bayer_mod
from neural_imaging_tpu_torch.models.base import (REPO_ROOT, TorchModel, _parse_tuple_args,
                                                  flax_default_init)
from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.ops.kernels import (EXAMPLE_SRGB, bilin_kernel, gamma_kernels,
                                                  upsampling_kernel)
from neural_imaging_tpu_torch.parallel import mesh as mesh_lib
from neural_imaging_tpu_torch.utils import prng
from neural_imaging_tpu_torch.utils.paramspec import ParamSpec
from neural_imaging_tpu_torch.utils.utils import format_patch_shape

# INet's conv precisions → ops.conv2d's: 'exact' and 'exact_chw' are the
# reference's layouts of the float32 convolution; 'high' and 'default' round
# the operands as a matrix unit does (ops.at_precision)
CONV_PRECISIONS = {'exact': 'highest', 'exact_chw': 'highest', 'highest': 'highest',
                   'high': 'high', 'default': 'default'}
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
CFA_PATTERNS = ('gbrg', 'rggb', 'bggr')
# where a snapshot name without a '/' is looked up, as in the reference
NIP_DIR = 'data/models/nip'


# ====================================================================================
# Cores
# ====================================================================================

class INetCore(nn.Module):
    """Classic pipeline as a CNN: fixed 1x1 CFA upsampling → TF-order
    depth_to_space → reflect pad → demosaic conv → 1x1 sRGB → 2-layer tanh
    gamma net → straight-through clip. All but the upsampling kernel are
    parameters (unless ``trainable_upsampling``). Works on NCHW; each conv at
    ``precision`` ('highest' | 'high' | 'default', ``ops.conv2d``)."""

    def __init__(self, kernel=5, random_init=False, trainable_upsampling=False,
                 cfa_pattern='gbrg', precision='highest'):
        super().__init__()
        self.kernel = kernel
        self.precision = precision
        rng = np.random.RandomState(1234)
        upk = upsampling_kernel(cfa_pattern).reshape(1, 1, 4, 12)
        if random_init:
            dmf = rng.normal(0, 0.1, (kernel, kernel, 3, 3))
            g1k = rng.normal(0, 0.1, (1, 1, 3, 12))
            g1b = np.zeros(12)
            g2k = rng.normal(0, 0.1, (1, 1, 12, 3))
            g2b = np.zeros(3)
            srgbk = np.eye(3).reshape(1, 1, 3, 3)
        else:
            dmf = bilin_kernel(kernel)
            d1k, g1b, d2k, g2b = gamma_kernels()
            g1k, g2k = d1k.reshape(1, 1, 3, 12), d2k.reshape(1, 1, 12, 3)
            srgbk = EXAMPLE_SRGB.T.reshape(1, 1, 3, 3)

        if trainable_upsampling:
            self.upsampling = nn.Parameter(ops.hwio_to_oihw(upk))
        else:
            self.register_buffer('upsampling', ops.hwio_to_oihw(upk), persistent=False)
        self.demosaic = nn.Parameter(ops.hwio_to_oihw(dmf))
        self.srgb = nn.Parameter(ops.hwio_to_oihw(srgbk))
        self.gamma_d1_kernel = nn.Parameter(ops.hwio_to_oihw(g1k))
        self.gamma_d1_bias = nn.Parameter(torch.as_tensor(g1b, dtype=torch.float32))
        self.gamma_d2_kernel = nn.Parameter(ops.hwio_to_oihw(g2k))
        self.gamma_d2_bias = nn.Parameter(torch.as_tensor(g2b, dtype=torch.float32))

    def forward(self, x):
        """(N, 4, h, w) RAW stack → (N, 3, 2h, 2w) RGB in [0,1]."""
        def conv(t, k, padding='SAME'):
            return ops.conv2d(t, k, padding, precision=self.precision)

        bayer = ops.depth_to_space(conv(x, self.upsampling), 2)
        bayer = ops.pad2d(bayer, (self.kernel - 1) // 2, 'reflect')
        rgb = conv(bayer, self.demosaic, padding='VALID')
        srgb = conv(rgb, self.srgb)
        g = torch.tanh(conv(srgb, self.gamma_d1_kernel) + self.gamma_d1_bias[:, None, None])
        y = conv(g, self.gamma_d2_kernel) + self.gamma_d2_bias[:, None, None]
        return ops.st_clip(y)


def _conv_layer(cin, cout, k, key, padding=0, bias=True):
    """An ``nn.Conv2d`` with flax's default init (LeCun normal from the
    parameter key ``key``, zero bias)."""
    m = nn.utils.skip_init(nn.Conv2d, cin, cout, k, padding=padding, bias=bias)
    return flax_default_init(m, key)


def _apply_conv(layer, h, dtype):
    """``layer`` (a conv or a transposed conv) on h in float32, or in
    bfloat16 with flax's rounding points: the conv rounded to bfloat16, then
    the bfloat16 bias added."""
    if dtype == torch.float32:
        return layer(h)
    w = layer.weight.to(dtype)
    if isinstance(layer, nn.ConvTranspose2d):
        y = F.conv_transpose2d(h, w, None, layer.stride)
    else:
        y = F.conv2d(h, w, None, layer.stride, layer.padding)
    return y if layer.bias is None else y + layer.bias.to(dtype)[:, None, None]


class UNetCore(nn.Module):
    """UNet developer: ``n_steps`` levels of two 3x3 convs of 32·2^(n-1)
    channels with the activation, 2x2 max-pools 'SAME' between them, 2x2
    stride-2 transposed convs back up with skip concatenations, a 12-channel
    head, TF-order depth_to_space and the straight-through clip."""

    def __init__(self, n_steps=5, activation='leaky_relu', dtype=torch.float32,
                 in_channels=4, seed=0):
        super().__init__()
        root = prng.prng_key(seed)

        def conv(name, cin, cout):
            setattr(self, name, _conv_layer(cin, cout, 3, prng.flax_param_key(root, name),
                                            padding=1))
        self.n_steps = n_steps
        self.act = ops.ACTIVATIONS[activation]
        self.compute_dtype = dtype
        cin = in_channels
        for n in range(1, n_steps + 1):
            ch = 32 * 2 ** (n - 1)
            conv(f'enc{n}_1', cin, ch)
            conv(f'enc{n}_2', ch, ch)
            cin = ch
        for n in range(1, n_steps):
            ch = 32 * 2 ** (n_steps - n - 1)
            up = nn.utils.skip_init(nn.ConvTranspose2d, cin, ch, 2, stride=2)
            setattr(self, f'dec{n}_up',
                    flax_default_init(up, prng.flax_param_key(root, f'dec{n}_up')))
            conv(f'dec{n}_1', 2 * ch, ch)
            conv(f'dec{n}_2', ch, ch)
            cin = ch
        conv('head', cin, 12)

    def forward(self, x):
        """(N, 4, h, w) RAW stack → (N, 3, 2h, 2w) RGB; h and w divisible by
        2^(n_steps - 1)."""
        dt = self.compute_dtype

        def conv(name, h):
            return _apply_conv(getattr(self, name), h, dt)

        skips = []
        h = x.to(dt)
        for n in range(1, self.n_steps + 1):
            h = self.act(conv(f'enc{n}_1', h))
            h = self.act(conv(f'enc{n}_2', h))
            if n < self.n_steps:
                skips.append(h)
                h = ops.max_pool(h, 2, padding='SAME')
        for n in range(1, self.n_steps):
            h = torch.cat([conv(f'dec{n}_up', h), skips[-n]], dim=1)
            h = self.act(conv(f'dec{n}_1', h))
            h = self.act(conv(f'dec{n}_2', h))
        y = ops.depth_to_space(conv('head', h).to(torch.float32), 2)
        return ops.st_clip(y)


class DNetCore(nn.Module):
    """Joint demosaicing and denoising: ``n_layers`` 'VALID' convs with ReLU,
    each followed by a reflect pad (the last of 12 features), TF-order
    depth_to_space of the features, concatenated with the Bayer mosaic that
    the fixed CFA upsampling scatters (an exact float32 conv), a 'project'
    conv with ReLU and reflect pad, and a bias-free 1x1 ``to_rgb`` (initial
    weights 1)."""

    def __init__(self, n_layers=15, kernel=3, n_features=64, dtype=torch.float32,
                 in_channels=4, seed=0):
        super().__init__()
        root = prng.prng_key(seed)
        self.n_layers = n_layers
        self.kernel = kernel
        self.compute_dtype = dtype
        cin = in_channels
        for r in range(n_layers):
            feats = 12 if r == n_layers - 1 else n_features
            setattr(self, f'conv{r}',
                    _conv_layer(cin, feats, kernel, prng.flax_param_key(root, f'conv{r}')))
            cin = feats
        self.project = _conv_layer(6, n_features, kernel, prng.flax_param_key(root, 'project'))
        self.to_rgb = nn.utils.skip_init(nn.Conv2d, n_features, 3, 1, bias=False)
        with torch.no_grad():
            self.to_rgb.weight.fill_(1.0)
        self.register_buffer('upsampling',
                             ops.hwio_to_oihw(upsampling_kernel().reshape(1, 1, 4, 12)),
                             persistent=False)

    def forward(self, x):
        """(N, 4, h, w) RAW stack → (N, 3, 2h, 2w) RGB."""
        dt = self.compute_dtype
        pad = (self.kernel - 1) // 2
        h = x.to(dt)
        for r in range(self.n_layers):
            h = torch.relu(_apply_conv(getattr(self, f'conv{r}'), h, dt))
            h = ops.pad2d(h, pad, 'reflect')
        bayer = ops.depth_to_space(ops.small_conv2d(x, self.upsampling), 2)
        features = ops.depth_to_space(h.to(torch.float32), 2)
        hf = torch.cat([features, bayer], dim=1).to(dt)
        hf = torch.relu(_apply_conv(self.project, hf, dt))
        hf = ops.pad2d(hf, pad, 'reflect')
        y = _apply_conv(self.to_rgb, hf, dt)
        return ops.st_clip(y.to(torch.float32))


class ONetCore(nn.Module):
    """The NULL ISP: identity on RGB inputs."""

    def forward(self, x):
        return x


class DemosaicingModule(nn.Module):
    """CNN demosaicing of a full-resolution scattered mosaic (N, 3, H, W):
    the residual form subtracts ``alpha`` times a learned tanh correction
    (none without ``c_filters``) from the fixed bilinear filter's result; the
    direct form is the CNN with a sigmoid output."""

    def __init__(self, c_filters=(), kernel=5, activation='leaky_relu', residual=True,
                 seed=0, scope=()):
        super().__init__()
        root = prng.prng_key(seed)
        self.c_filters = tuple(c_filters)
        self.kernel = kernel
        self.act = ops.ACTIVATIONS[activation]
        self.residual = residual
        pad = (kernel - 1) // 2
        cin = 3
        for i, nf in enumerate(self.c_filters):
            setattr(self, f'conv{i}', _conv_layer(
                cin, nf, kernel, prng.flax_param_key(root, (*scope, f'conv{i}')), padding=pad))
            cin = nf
        if self.c_filters or not residual:
            self.out = _conv_layer(cin, 3, 1, prng.flax_param_key(root, (*scope, 'out')))
        if residual:
            self.alpha = nn.Parameter(torch.tensor(0.1, dtype=torch.float32))
            self.register_buffer('bilinear', ops.hwio_to_oihw(bilin_kernel(kernel)),
                                 persistent=False)

    def _cnn(self, f):
        for i in range(len(self.c_filters)):
            f = self.act(getattr(self, f'conv{i}')(f))
        return self.out(f)

    def forward(self, bayer, clip=True):
        if self.residual:
            pad = (self.kernel - 1) // 2
            base = ops.small_conv2d(ops.pad2d(bayer, pad, 'reflect'), self.bilinear,
                                    padding='VALID')
            f = torch.tanh(self._cnn(bayer)) if self.c_filters else 0.0
            y = base - self.alpha * f
        else:
            y = torch.sigmoid(self._cnn(bayer))
        return ops.st_clip(y) if clip else y


def _percentile_normalize_nchw(rgb):
    """``ops.percentile_normalize`` of an NCHW batch over its values in NHWC
    order, the reference's: clipped images tie at 0 and 1, and the stable
    sort gives a percentile's gradient to the first of the tied values in
    that order."""
    return ops.percentile_normalize(rgb.permute(0, 2, 3, 1), 0.5).permute(0, 3, 1, 2)


class ClassicISPCore(nn.Module):
    """Classic ISP with neural demosaicing: fixed CFA upsampling → TF-order
    depth_to_space → ``DemosaicingModule`` → the sRGB matrix (an input of the
    forward; the buffer ``srgb`` where none is given) → optional brightness
    normalization ('percentile' or 'shift') → a stop-gradient clip to
    [1/255, 1] → gamma 1/2.2."""

    def __init__(self, kernel=5, c_filters=(), cfa_pattern='gbrg', residual=True,
                 brightness='', seed=0):
        super().__init__()
        self.brightness = brightness
        self.register_buffer('upsampling', torch.zeros(12, 4, 1, 1), persistent=False)
        self.register_buffer('srgb', torch.eye(3), persistent=False)
        self.set_cfa_pattern(cfa_pattern)
        self.demosaicing = DemosaicingModule(c_filters, kernel, 'leaky_relu', residual,
                                             seed, scope=('demosaicing',))

    def set_cfa_pattern(self, cfa_pattern):
        upk = ops.hwio_to_oihw(upsampling_kernel(cfa_pattern).reshape(1, 1, 4, 12))
        self.upsampling.copy_(upk)

    def linear(self, x, srgb_mat=None):
        """The stages before the brightness normalization: the sRGB image."""
        bayer = ops.depth_to_space(ops.small_conv2d(x, self.upsampling), 2)
        rgb = self.demosaicing(bayer)
        m = self.srgb if srgb_mat is None else srgb_mat
        return torch.einsum('nchw,kc->nkhw', rgb, m.to(rgb))

    @staticmethod
    def tone(rgb):
        """The stages after it: the stop-gradient clip and gamma 1/2.2."""
        y = (torch.clamp(rgb, 1.0 / 255, 1.0) - rgb).detach() + rgb
        return torch.pow(y, 1 / 2.2)

    def forward(self, x, srgb_mat=None):
        rgb = self.linear(x, srgb_mat)
        if self.brightness == 'percentile':
            rgb = _percentile_normalize_nchw(rgb)
        elif self.brightness == 'shift':
            rgb = rgb * (0.25 / torch.clamp(ops.batch_mean(rgb), min=1e-9))
        return self.tone(rgb)


# ====================================================================================
# Shells
# ====================================================================================

class NIPModel(TorchModel):
    """A camera ISP: its core, the fidelity loss, the Adam state of its own
    training step, the metric history, and snapshots in the JAX package's
    format (a name without a '/' is looked up under ``data/models/nip``)."""

    def __init__(self, module, patch_size=None, in_channels=4, loss_metric='L2',
                 device='cuda'):
        if loss_metric not in ops.LOSSES:
            raise ValueError(f'Unsupported loss metric {loss_metric!r}')
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.loss_metric = loss_metric
        super().__init__(module, device)
        self._scan_step = 0
        self.init_optimizer()

    # -- compute ---------------------------------------------------------------------

    def loss(self, batch_y, batch_Y):
        """The fidelity loss ``ops.LOSSES[loss_metric]`` of two NHWC batches."""
        return ops.LOSSES[self.loss_metric](batch_y, batch_Y)

    def _develop(self, x):
        """The core on an NCHW batch."""
        return self.module(x)

    def process(self, batch_x):
        """Develop an NHWC RAW batch (N, h, w, 4) → NHWC RGB (N, 2h, 2w, 3)."""
        x = torch.as_tensor(batch_x, dtype=torch.float32, device=self.device)
        if x.ndim == 3:
            x = x[None]
        with torch.no_grad():
            return self._develop(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def init_optimizer(self):
        """(Re)start Adam (optax's ``scale_by_adam`` defaults); the learning
        rate is set at each step. None for a model without parameters."""
        params = list(self.module.parameters())
        self.optimizer = (torch.optim.Adam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
                          if params else None)

    def _step(self, batch_x, batch_y, learning_rate):
        """One Adam step on float NHWC batches; the loss, a 0-d device tensor.
        Under ``parallel`` the batches are this rank's rows of the global
        batch: the rank differentiates its share of the global mean (its mean
        over the rank count), the shares' gradients and values are summed
        over the ranks, and the global loss is returned."""
        self.module.zero_grad(set_to_none=True)
        mesh = self.parallel.mesh if self.parallel is not None else None
        with mesh_lib.batch_reductions(mesh):
            developed = self._develop(batch_x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            loss = self.loss(developed, batch_y)
            if self.parallel is not None:
                loss = loss / self.parallel.n_devices
            loss.backward()
        if self.parallel is not None:
            params = [p for p in self.module.parameters() if p.grad is not None]
            grads, (loss,) = self.parallel.reduce([p.grad for p in params], [loss.detach()])
            for p, g in zip(params, grads):
                p.grad = g
        for group in self.optimizer.param_groups:
            group['lr'] = float(learning_rate)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    def training_step(self, batch_x, batch_y, learning_rate=1e-4):
        """One Adam step on an NHWC RAW batch and its RGB target (uint16 /
        uint8 batches are normalized here, float ones taken as they are);
        returns the loss, a 0-d tensor on the device (no host sync)."""
        x, y = (ops.normalize_batch(torch.as_tensor(b).to(self.device))
                for b in (batch_x, batch_y))
        return self._step(x, y, learning_rate)

    def training_scan(self, sampler, n_steps, learning_rate=1e-4):
        """``n_steps`` training steps on batches that ``sampler`` (a
        ``DeviceSampler`` of RAW and RGB on the model's device) draws on the
        device, numbered on from the model's last scanned step. Returns the
        per-step losses, a tensor on the device."""
        losses = []
        for _ in range(n_steps):
            raw, rgb = sampler(self._scan_step)
            self._scan_step += 1
            losses.append(self._step(ops.normalize_batch(raw), ops.normalize_batch(rgb),
                                     learning_rate))
        return torch.stack(losses)

    # -- bookkeeping -----------------------------------------------------------------

    def reset_performance_stats(self):
        self.performance = {
            'loss': {'training': [], 'validation': []},
            'psnr': {'validation': []},
            'ssim': {'validation': []},
        }

    def get_hyperparameters(self):
        p = {'in_channels': self.in_channels}
        if hasattr(self, '_h'):
            p.update(self._h.to_json())
        return p

    @property
    def patch_size_raw(self):
        return (self.patch_size, self.patch_size, self.in_channels)

    @property
    def patch_size_rgb(self):
        if self.patch_size is None:
            return None
        return (2 * self.patch_size, 2 * self.patch_size, 3)

    def summary(self):
        return '{} : {} -> {}'.format(super().summary(), format_patch_shape(self.patch_size_raw),
                                      format_patch_shape(self.patch_size_rgb))

    def load_model(self, dirname, quiet=False):
        """Load the snapshot (``dirname`` without a '/' under
        ``data/models/nip``) and restart the Adam state."""
        if '/' not in dirname:
            dirname = os.path.join(NIP_DIR, dirname)
        super().load_model(dirname, quiet=quiet)
        self.init_optimizer()

    def save_model(self, dirname, epoch=0, save_args=False, quiet=False):
        if '/' not in dirname:
            dirname = os.path.join(NIP_DIR, dirname)
        super().save_model(dirname, epoch=epoch, save_args=save_args, quiet=quiet)

    @classmethod
    def restore(cls, dir_name, patch_size=None, device='cuda', **kwargs):
        """The model of a snapshot directory, built from the first training
        log under it (its 'args'), as the reference's ``TPUModel.restore``."""
        from pathlib import Path
        candidates = sorted(Path(dir_name).glob('**/*.json'))
        if not candidates:
            raise FileNotFoundError(f'Could not find a training log (JSON file) in {dir_name}')
        training_log = json.loads(candidates[0].read_text())
        parameters = _parse_tuple_args(dict(training_log['args'] or {}))
        if patch_size is not None:
            parameters['patch_size'] = patch_size
        instance = cls(**parameters, **kwargs, device=device)
        instance.load_model(str(dir_name))
        return instance

    def process_fingerprint(self, k0, demosaicing=True, cfa_pattern=None):
        """Map a RAW-level PRNU fingerprint (h/2, w/2, 4) to RGB space."""
        cfa = cfa_pattern or getattr(getattr(self, '_h', None), 'cfa_pattern', None)
        if cfa is None:
            raise ValueError('This ISP is not aware of the CFA! Pass cfa_pattern explicitly.')
        k0m = bayer_mod.merge_bayer(k0, cfa)
        if demosaicing:
            if not hasattr(self, 'demosaic_only'):
                raise ValueError(f'{self.class_name} does not expose a demosaicing stage')
            return self.demosaic_only(k0m[None]).cpu().numpy()
        return k0m.sum(-1)


class INet(NIPModel):
    """Neural replication of the classic pipeline steps."""

    def __init__(self, patch_size=None, random_init=False, kernel=5,
                 trainable_upsampling=False, cfa_pattern='gbrg', conv_precision='exact',
                 loss_metric='L2', in_channels=4, device='cuda'):
        if conv_precision not in CONV_PRECISIONS:
            raise ValueError(f'Unsupported conv precision {conv_precision!r}; use one of '
                             f'{list(CONV_PRECISIONS)}')
        if cfa_pattern.lower() not in CFA_PATTERNS:
            raise ValueError(f'Unsupported CFA pattern {cfa_pattern!r}')
        self._h = ParamSpec({'random_init': (False, bool), 'kernel': (5, int),
                             'trainable_upsampling': (False, bool),
                             'cfa_pattern': ('gbrg', str), 'conv_precision': ('exact', str)})
        self._h.update(random_init=random_init, kernel=kernel,
                       trainable_upsampling=trainable_upsampling, cfa_pattern=cfa_pattern,
                       conv_precision=conv_precision)
        super().__init__(INetCore(kernel=kernel, random_init=random_init,
                                  trainable_upsampling=trainable_upsampling,
                                  cfa_pattern=cfa_pattern,
                                  precision=CONV_PRECISIONS[conv_precision]),
                         patch_size, in_channels, loss_metric, device)

    @property
    def model_code(self):
        return '{c}_{cfa}{tu}{r}_{k}x{k}'.format(
            c=self.class_name, cfa=self._h.cfa_pattern, k=self._h.kernel,
            tu='T' if self._h.trainable_upsampling else '',
            r='R' if self._h.random_init else '')


def _check_range(name, value, lo, hi):
    if not lo <= value <= hi:
        raise ValueError(f'{name}={value} out of range [{lo}, {hi}]')


class UNet(NIPModel):
    """UNet-based developer."""

    def __init__(self, patch_size=None, n_steps=5, activation='leaky_relu', dtype='float32',
                 loss_metric='L2', in_channels=4, device='cuda'):
        _check_range('n_steps', n_steps, 2, 6)
        if activation not in ops.ACTIVATIONS or dtype not in DTYPES:
            raise ValueError(f'Unsupported activation {activation!r} or dtype {dtype!r}')
        self._h = ParamSpec({'n_steps': (5, int), 'activation': ('leaky_relu', str)})
        self._h.update(n_steps=n_steps, activation=activation)
        super().__init__(UNetCore(n_steps, activation, DTYPES[dtype], in_channels),
                         patch_size, in_channels, loss_metric, device)

    @property
    def model_code(self):
        return f'{self.class_name}_{self._h.n_steps}'


class DNet(NIPModel):
    """Joint demosaicing and denoising developer."""

    def __init__(self, patch_size=None, n_layers=15, kernel=3, n_features=64, dtype='float32',
                 loss_metric='L2', in_channels=4, device='cuda'):
        _check_range('n_layers', n_layers, 1, 32)
        _check_range('kernel', kernel, 3, 11)
        _check_range('n_features', n_features, 4, 128)
        if dtype not in DTYPES:
            raise ValueError(f'Unsupported dtype {dtype!r}')
        self._h = ParamSpec({'n_layers': (15, int), 'kernel': (3, int),
                             'n_features': (64, int)})
        self._h.update(n_layers=n_layers, kernel=kernel, n_features=n_features)
        super().__init__(DNetCore(n_layers, kernel, n_features, DTYPES[dtype], in_channels),
                         patch_size, in_channels, loss_metric, device)

    @property
    def model_code(self):
        return '{c}_{k}x{k}_{l}x{f}f'.format(c=self.class_name, k=self._h.kernel,
                                             f=self._h.n_features, l=self._h.n_layers)


class ONet(NIPModel):
    """NULL ISP passing RGB straight through (for RGB-only workflows)."""

    def __init__(self, patch_size=None, loss_metric='L2', in_channels=3, device='cuda'):
        patch_size = 2 * patch_size if patch_size is not None else None
        super().__init__(ONetCore(), patch_size, 3, loss_metric, device)

    @property
    def patch_size_rgb(self):
        if self.patch_size is None:
            return None
        return (self.patch_size, self.patch_size, 3)

    @property
    def model_code(self):
        return self.class_name


class ClassicISP(NIPModel):
    """Classic camera ISP with neural demosaicing and camera profiles set at
    run time (``set_camera``, ``set_cfa_pattern``, ``set_srgb_conversion``)."""

    def __init__(self, patch_size=None, srgb_mat=None, kernel=5, c_filters=(),
                 cfa_pattern='gbrg', residual=True, brightness=None, loss_metric='L2',
                 in_channels=4, device='cuda'):
        if isinstance(c_filters, str):
            # the logs store tuples as strings, e.g. "(16,)"
            c_filters = ast.literal_eval(c_filters)
        if isinstance(c_filters, (int, float)):
            c_filters = (int(c_filters),)
        _check_range('kernel', kernel, 3, 11)
        if cfa_pattern.lower() not in CFA_PATTERNS:
            raise ValueError(f'Unsupported CFA pattern {cfa_pattern!r}')
        if any(not 1 <= int(f) <= 1024 for f in c_filters):
            raise ValueError(f'c_filters {c_filters} out of range [1, 1024]')
        if brightness not in (None, '', 'percentile', 'shift'):
            raise ValueError(f'Unsupported brightness normalization {brightness!r}')
        self._h = ParamSpec({'kernel': (5, int), 'c_filters': ((), tuple),
                             'cfa_pattern': ('gbrg', str), 'residual': (True, bool)})
        self._h.update(kernel=kernel, c_filters=tuple(int(f) for f in c_filters),
                       cfa_pattern=cfa_pattern.lower(), residual=residual)
        self._brightness = brightness or ''
        super().__init__(ClassicISPCore(self._h.kernel, self._h.c_filters, self._h.cfa_pattern,
                                        self._h.residual, self._brightness),
                         patch_size, in_channels, loss_metric, device)
        self.set_srgb_conversion(np.eye(3) if srgb_mat is None else srgb_mat)

    def set_cfa_pattern(self, cfa_pattern):
        if cfa_pattern is not None:
            self._h.update(cfa_pattern=cfa_pattern.lower())
            self.module.set_cfa_pattern(self._h.cfa_pattern)

    def set_srgb_conversion(self, srgb_mat):
        """The camera → sRGB matrix M (out_k = Σ_c M[k, c] rgb_c)."""
        if srgb_mat is not None:
            self.module.srgb.copy_(torch.as_tensor(np.asarray(srgb_mat, dtype=np.float32)))

    def set_camera(self, camera, config_path=None):
        """Set the CFA and the sRGB matrix from ``config/cameras.json``."""
        config_path = config_path or REPO_ROOT / 'config' / 'cameras.json'
        with open(config_path) as f:
            cameras = json.load(f)
        self.set_cfa_pattern(cameras[camera]['cfa'])
        self.set_srgb_conversion(np.array(cameras[camera]['srgb']))

    def process(self, batch_x, cfa_pattern=None, srgb_mat=None):
        self.set_cfa_pattern(cfa_pattern)
        self.set_srgb_conversion(srgb_mat)
        return super().process(batch_x)

    def demosaic_only(self, bayer_rgb):
        """Only the demosaicing block, unclipped, on an NHWC full-resolution
        scattered mosaic; NHWC out."""
        x = torch.as_tensor(bayer_rgb, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return self.module.demosaicing(x.permute(0, 3, 1, 2), clip=False).permute(0, 2, 3, 1)

    @classmethod
    def restore(cls, dir_name='data/models/isp/ClassicISP_auto_3x3_32-32-32-32-3R/', *,
                camera=None, cfa=None, srgb=None, patch_size=128, device='cuda'):
        isp = super().restore(dir_name, patch_size=patch_size, device=device)
        if camera is not None:
            isp.set_camera(camera)
        if cfa is not None:
            isp.set_cfa_pattern(cfa)
        if srgb is not None:
            isp.set_srgb_conversion(srgb)
        return isp

    @property
    def model_code(self):
        fs = '-'.join(str(x) for x in self._h.c_filters)
        return 'ClassicISP_{cfa}_{k}x{k}_{fs}-{of}{r}'.format(
            fs=fs, of=3, k=self._h.kernel, cfa=self._h.cfa_pattern,
            r='R' if self._h.residual else '')

    def summary(self):
        nf = len(self._h.c_filters)
        fs = self._h.c_filters[0] if len(set(self._h.c_filters)) == 1 else '*'
        k = self._h.kernel
        return (f'{self.class_name}[{self._h.cfa_pattern}] + CNN demosaicing '
                f'[{nf}+1 layers : {k}x{k}x{fs} -> 1x1x3]')

    def summary_compact(self):
        nf = len(self._h.c_filters)
        fs = self._h.c_filters[0] if len(set(self._h.c_filters)) == 1 else '*'
        return (f'{self.class_name}[{self._h.cfa_pattern}, {nf}+1 conv2D '
                f'{self._h.kernel}x{self._h.kernel}x{fs} > 1x1x3]')


def tensor_isp(x, srgb_mat=None, cfa_pattern='gbrg', brightness='percentile'):
    """Toy stateless ISP for debugging and testing: fixed CFA upsampling →
    depth_to_space → reflect-padded bilinear demosaic → sRGB matrix →
    optional brightness normalization ('percentile', 'shift' or None) →
    straight-through clip → gamma 1/2.2. ``x``: an (N, h/2, w/2, 4) RGGB
    stack in [0,1] (NHWC, a tensor or numpy); returns (N, h, w, 3)."""
    kernel = 5
    x = torch.as_tensor(x, dtype=torch.float32).permute(0, 3, 1, 2)
    upk = upsampling_kernel(cfa_pattern).reshape(1, 1, 4, 12)
    srgb_k = np.asarray(np.eye(3) if srgb_mat is None else srgb_mat,
                        np.float32).T.reshape(1, 1, 3, 3)
    pad = (kernel - 1) // 2
    bayer = ops.depth_to_space(ops.small_conv2d(x, upk), 2)
    rgb = ops.small_conv2d(ops.pad2d(bayer, pad, 'reflect'), bilin_kernel(kernel),
                           padding='VALID')
    rgb = ops.small_conv2d(rgb, srgb_k)
    if brightness:
        if brightness == 'percentile':
            rgb = _percentile_normalize_nchw(rgb)
        elif brightness == 'shift':
            rgb = rgb * (0.25 / torch.mean(rgb))
        else:
            raise ValueError('Brightness normalization not recognized!')
    return torch.pow(ops.st_clip(rgb), 1 / 2.2).permute(0, 2, 3, 1)


supported_models = ['ClassicISP', 'DNet', 'INet', 'ONet', 'UNet']
