"""
Learned image compression: the DCN family. Port of
``neural_imaging_tpu/models/compression.py`` (``TwitterEncoder``,
``TwitterDecoder``, ``DCN``, ``TwitterDCN``).

The latent is quantized against a codebook (fixed, or trainable with
``train_codebook``) after a learned scale, and an entropy term on the
quantized latent regularizes the L2 loss. With 'soft-codebook' rounding, the
default, quantization and entropy go through the fused kernels of
``ops/hopper/codebook.py``: K2 forward, K3 (fixed codebook) or K4 (trainable)
backward, on CUDA tensors; their plain versions on CPU tensors.

Tensors are NCHW inside; ``compress``, ``decompress``, ``process`` and
``training_step`` take and return NHWC, as the reference's do.
``training_scan`` runs steps on batches that a ``DeviceSampler`` draws on
the device, with the reference's in-graph flips and gamma drawn from a
``torch.Generator`` seeded as its ``PRNGKey(29)``; PyTorch cannot
reproduce JAX's key stream, so the draws agree with the reference's in
distribution, not value by value.
"""
import numpy as np
import torch
from torch import nn

from neural_imaging_tpu_torch.models.base import TorchModel, flax_default_init
from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.ops import quantization as quant
from neural_imaging_tpu_torch.ops import ssim as ssim_ops
from neural_imaging_tpu_torch.ops.hopper.codebook import quantize_with_entropy_fused
from neural_imaging_tpu_torch.parallel import mesh as mesh_lib
from neural_imaging_tpu_torch.utils import prng
from neural_imaging_tpu_torch.utils.paramspec import ParamSpec

ROUNDING_MODES = ('identity', 'soft', 'soft-codebook', 'sin')
# the training augmentations' default probabilities (the host-fed trainer's
# and training_scan's; the scan has no resize) and the range of the gamma draw
AUGMENTATION_PROBS = {'resize': 0.0, 'flip_h': 0.5, 'flip_v': 0.5, 'gamma': 0.5}
GAMMA_RANGE = (0.25, 3.0)
SCAN_SEED = 29


class Conv(nn.Module):
    """flax ``nn.Conv`` with its defaults: TF 'SAME' padding at any stride,
    a bias, LeCun-normal init from the parameter key ``key``. Weight OIHW."""

    def __init__(self, cin, cout, kernel, stride, key):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))
        flax_default_init(self, key)

    def forward(self, x):
        return ops.conv2d(x, self.weight, 'SAME', self.stride, self.bias)


def _residual_blocks(module, act, h):
    for i in range(3):
        res = act(getattr(module, f'res{i}_1')(h))
        h = h + getattr(module, f'res{i}_2')(res)
    return h


def _add_conv(module, root, name, cin, cout, kernel, stride=1):
    """The flax module's conv ``name``, drawn as flax's ``init(root, ...)``
    draws it."""
    setattr(module, name, Conv(cin, cout, kernel, stride, prng.flax_param_key(root, name)))


def _add_residual_blocks(module, root):
    for i in range(3):
        _add_conv(module, root, f'res{i}_1', 128, 128, 3)
        _add_conv(module, root, f'res{i}_2', 128, 128, 3)


class TwitterEncoder(nn.Module):
    """Two 5x5 stride-2 convs (64, 128), three residual blocks, a 5x5
    stride-2 conv to ``n_features``: (N, 3, h, w) → (N, F, h/8, w/8).
    Initialized as the reference's flax module from the key ``root``."""

    def __init__(self, n_features, activation, root):
        super().__init__()
        self.act = ops.ACTIVATIONS[activation]
        _add_conv(self, root, 'down1', 3, 64, 5, 2)
        _add_conv(self, root, 'down2', 64, 128, 5, 2)
        _add_residual_blocks(self, root)
        _add_conv(self, root, 'to_latent', 128, n_features, 5, 2)

    def forward(self, x):
        h = self.act(self.down1(2.0 * (x - 0.5)))
        # the reference fixes this nonlinearity to leaky ReLU 0.2 whatever the activation
        r = ops.leaky_relu(self.down2(h), 0.2)
        return self.to_latent(_residual_blocks(self, self.act, r))


class TwitterDecoder(nn.Module):
    """Mirror of the encoder with three TF-order depth_to_space upsamples
    (512 → 256 → 12 channels): (N, F, h, w) → (N, 3, 8h, 8w) in [0, 1].
    Initialized as the reference's flax module from the key ``root``."""

    def __init__(self, n_features, activation, root):
        super().__init__()
        self.act = ops.ACTIVATIONS[activation]
        _add_conv(self, root, 'up1', n_features, 512, 3)
        _add_residual_blocks(self, root)
        _add_conv(self, root, 'up2', 128, 256, 3)
        _add_conv(self, root, 'up3', 64, 12, 3)

    def forward(self, z):
        h = _residual_blocks(self, self.act, ops.depth_to_space(self.up1(z), 2))
        h = ops.depth_to_space(self.act(self.up2(h)), 2)
        h = ops.depth_to_space(self.up3(h), 2)
        return ops.st_clip((h + 1.0) / 2.0)


class DCNCore(nn.Module):
    """The codec's parameters: ``encoder``, ``decoder``, the 0-d
    ``latent_scale`` (with ``scale_latent``) and the (L,) ``codebook`` (with
    ``train_codebook``), named as the reference's checkpoint names them."""

    def __init__(self, encoder, decoder, scale_latent, codebook):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        if scale_latent:
            self.latent_scale = nn.Parameter(torch.ones(()))
        if codebook is not None:
            self.codebook = nn.Parameter(torch.as_tensor(codebook, dtype=torch.float32))


class DCN(TorchModel):
    """Learned codec: latent quantization against a (fixed or trainable)
    codebook after a learned scale, entropy-regularized L2 loss, Adam
    training step, compress / decompress / process and compression
    statistics. Subclasses build the encoder and decoder
    (:meth:`construct_model`)."""

    def __init__(self, patch_size=128, latent_bpf=5, rounding='soft-codebook',
                 train_codebook=False, entropy_weight=250, scale_latent=True,
                 use_batchnorm=False, loss_metric='L2', v=50.0, gamma=25.0, seed=0,
                 device='cuda', **kwargs):
        if not (isinstance(latent_bpf, int) and 1 <= latent_bpf <= 8):
            raise ValueError(f'latent_bpf must be an integer in [1, 8], got {latent_bpf!r}')
        if rounding not in ROUNDING_MODES:
            raise ValueError(f'Unsupported rounding {rounding!r}; one of {ROUNDING_MODES}')
        if loss_metric != 'L2':
            raise ValueError(f'Unsupported loss_metric {loss_metric!r}')
        if not 0 <= float(entropy_weight) <= 1e6:
            raise ValueError(f'entropy_weight must be in [0, 1e6], got {entropy_weight!r}')
        # the reference's spec: its defaults decide what ``repr`` lists
        self._h = ParamSpec({'latent_bpf': (5, int), 'train_codebook': (False, bool),
                             'entropy_weight': (250.0, float), 'scale_latent': (True, bool),
                             'use_batchnorm': (False, bool), 'loss_metric': ('L2', str),
                             'rounding': ('soft', str)})
        self._h.update(latent_bpf=latent_bpf, train_codebook=train_codebook,
                       entropy_weight=entropy_weight, scale_latent=scale_latent,
                       use_batchnorm=use_batchnorm, loss_metric=loss_metric, rounding=rounding)
        self.patch_size = patch_size
        self.v, self.gamma = float(v), float(gamma)
        # the reference initializes its encoder and decoder from the two
        # halves of split(PRNGKey(seed))
        encoder, decoder = self.construct_model(*prng.split(prng.prng_key(seed)), **kwargs)
        codebook = quant.default_codebook(latent_bpf) if train_codebook else None
        super().__init__(DCNCore(encoder, decoder, scale_latent, codebook), device)
        self._fixed_codebook = torch.from_numpy(quant.default_codebook(latent_bpf)).to(self.device)
        self._scan_step = 0
        self._scan_generator = None
        self.init_optimizer()

    def construct_model(self, encoder_key, decoder_key, **kwargs):
        """Return (encoder, decoder) modules, initialized from their keys, and
        record their hyper-parameters."""
        raise NotImplementedError

    def init_optimizer(self):
        """Adam with the reference's constants (optax ``scale_by_adam``, then
        −lr·u); the learning rate is set at every step."""
        self.optimizer = torch.optim.Adam(self.module.parameters(), lr=1e-4,
                                          betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)

    def load_model(self, dirname):
        super().load_model(dirname)
        self.init_optimizer()

    # -- latent machinery -------------------------------------------------------------

    def _codebook(self):
        return self.module.codebook if self._h.train_codebook else self._fixed_codebook

    def get_codebook(self):
        """The codebook as a numpy float32 array (L,)."""
        return self._codebook().detach().cpu().numpy().reshape(-1)

    def _quantize_latent(self, z):
        """Scale → quantize → entropy of the quantized latent."""
        if self._h.scale_latent:
            z = z * self.module.latent_scale
        if self._h.rounding == 'soft-codebook':
            q, entropy, _ = quantize_with_entropy_fused(z, self._codebook(), self.v, self.gamma,
                                                        trainable=self._h.train_codebook)
        else:
            q, entropy, _ = quant.quantize_with_entropy(z, self._codebook(), self._h.rounding,
                                                        self.v, self.gamma)
        return q, entropy

    def _encode(self, x):
        return self._quantize_latent(self.module.encoder(x))

    def _apply(self, x):
        q, entropy = self._encode(x)
        return self.module.decoder(q), entropy

    def loss(self, batch_x, batch_y, entropy):
        """L2 (``tf.nn.l2_loss`` convention: 0.5·Σ²) + entropy_weight · H."""
        return ops.l2_loss(batch_x - batch_y) + self._h.entropy_weight * entropy

    def _nchw(self, batch):
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        if x.ndim == 3:
            x = x[None]
        return x.permute(0, 3, 1, 2)

    # -- public API -------------------------------------------------------------------

    def compress(self, batch_x):
        """Quantized latent of an NHWC RGB batch: (N, h/8, w/8, F) on the device."""
        with torch.no_grad():
            return self._encode(self._nchw(batch_x))[0].permute(0, 2, 3, 1)

    def decompress(self, batch_z):
        """NHWC RGB batch decoded from an NHWC latent."""
        with torch.no_grad():
            return self.module.decoder(self._nchw(batch_z)).permute(0, 2, 3, 1)

    def checkpoint(self):
        """The weights in the JAX package's order: the encoder's and the
        decoder's, then ``latent_scale`` and ``codebook``."""
        flat = super().checkpoint()
        return {**{k: v for k, v in flat.items() if '/' in k},
                **{k: v for k, v in flat.items() if '/' not in k}}

    def serve(self, x):
        """The JAX model's ``_apply``: (decoded NHWC batch, latent entropy)."""
        y, entropy = self._apply(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1), entropy

    def process(self, batch_x, return_entropy=False):
        with torch.no_grad():
            y, entropy = self._apply(self._nchw(batch_x))
        y = y.permute(0, 2, 3, 1)
        return (y, entropy) if return_entropy else y

    def _step(self, x, learning_rate):
        """One Adam step on an NHWC float batch in [0, 1]; returns {loss
        (√(2L)), ssim (batch mean), entropy} as 0-d device tensors, from the
        forward pass before the update.

        Under ``parallel`` x is this rank's rows of the global batch and the
        step is the global batch's: the entropy is that of the global latent
        (``mesh.batch_reductions``), the rank differentiates its share of the
        global loss (its L2 sum and the entropy term over the rank count), and
        the shares' gradients, values and SSIMs are summed over the ranks."""
        for group in self.optimizer.param_groups:
            group['lr'] = learning_rate
        self.optimizer.zero_grad(set_to_none=True)
        x_nchw = x.permute(0, 3, 1, 2)
        world = 1 if self.parallel is None else self.parallel.n_devices
        with mesh_lib.batch_reductions(None if self.parallel is None else self.parallel.mesh):
            y, entropy = self._apply(x_nchw)
            # loss() is L2 + entropy_weight · H: a rank's share takes H / world
            loss = self.loss(x_nchw, y, entropy if world == 1 else entropy / world)
            loss.backward()
        with torch.no_grad():
            ssim = torch.mean(ssim_ops.ssim(x, y.permute(0, 2, 3, 1)))
        loss = loss.detach()
        if self.parallel is not None:
            params = [p for p in self.module.parameters() if p.grad is not None]
            grads, (loss, ssim) = self.parallel.reduce([p.grad for p in params],
                                                       [loss, ssim / world])
            for p, g in zip(params, grads):
                p.grad = g
        self.optimizer.step()
        return {'loss': torch.sqrt(2.0 * loss), 'ssim': ssim, 'entropy': entropy.detach()}

    def training_step(self, batch_x, learning_rate=None):
        """One Adam step on an NHWC batch (uint8, uint16 or float in [0, 1]).
        Returns {loss (√(2L)), ssim (batch mean), entropy} as 0-d device
        tensors, from the forward pass before the update. The gradients of
        the step stay in the parameters' ``.grad``."""
        x = ops.normalize_batch(torch.as_tensor(batch_x, device=self.device))
        if x.ndim == 3:
            x = x[None]
        return self._step(x, 1e-4 if learning_rate is None else float(learning_rate))

    def _augment(self, x, probs):
        """The reference's in-graph augmentations of an NHWC batch: a
        horizontal and a vertical flip of the whole batch and a gamma
        x^(1/γ), γ ~ U(0.25, 3) per image, each with its probability, drawn on
        the device."""
        g = self._scan_generator
        n = x.shape[0]
        world = 1 if self.parallel is None else self.parallel.n_devices
        u = torch.rand(3, generator=g, device=self.device)
        # drawn for the global batch, of which x is this rank's rows
        gamma = GAMMA_RANGE[0] + (GAMMA_RANGE[1] - GAMMA_RANGE[0]) * torch.rand(
            (n * world, 1, 1, 1), generator=g, device=self.device)
        if self.parallel is not None:
            gamma = mesh_lib.local_rows(gamma, n, self.parallel.mesh)
        x = torch.where(u[0] < probs['flip_h'], x.flip(2), x)
        x = torch.where(u[1] < probs['flip_v'], x.flip(1), x)
        return torch.where(u[2] < probs['gamma'], torch.pow(x, 1.0 / gamma).clamp(0, 1), x)

    def training_scan(self, sampler, n_steps, learning_rate=None, augmentation_probs=None):
        """``n_steps`` training steps on RGB batches that ``sampler`` (a
        ``DeviceSampler`` of RGB on the model's device) draws on the device,
        numbered on from the model's last scanned step, each augmented as
        :meth:`_augment` with ``augmentation_probs`` (default
        ``AUGMENTATION_PROBS``). Returns per-step {loss, ssim, entropy}
        tensors on the device."""
        probs = {**AUGMENTATION_PROBS, **(augmentation_probs or {})}
        if self._scan_generator is None:
            self._scan_generator = torch.Generator(device=self.device).manual_seed(SCAN_SEED)
        lr = 1e-4 if learning_rate is None else float(learning_rate)
        outs = []
        for _ in range(n_steps):
            rgb = sampler(self._scan_step)
            self._scan_step += 1
            outs.append(self._step(self._augment(ops.normalize_batch(rgb), probs), lr))
        return {k: torch.stack([o[k] for o in outs]) for k in ('loss', 'ssim', 'entropy')}

    # -- stats and names --------------------------------------------------------------

    def compression_stats(self, patch_size=None, n_latent_bytes=None):
        n_latent_bytes = n_latent_bytes or self._h.latent_bpf / 8
        ps = patch_size or self.patch_size
        if ps is None:
            raise ValueError('Patch size not specified!')
        n_latent = (ps // 8) * (ps // 8) * self.n_features
        bitmap_size = ps * ps * 3
        return {
            'rate': bitmap_size / (n_latent_bytes * n_latent),
            'bpp': 8 * n_latent * n_latent_bytes / (ps * ps),
            'bpf': 8 * n_latent_bytes,
            'bytes': n_latent * n_latent_bytes,
        }

    @property
    def latent_shape(self):
        if self.patch_size is None:
            return (None, None, self.n_features)
        return (self.patch_size // 8, self.patch_size // 8, self.n_features)

    @property
    def n_latent(self):
        if self.patch_size is None:
            return None
        return int(np.prod(self.latent_shape))

    def reset_performance_stats(self):
        self.performance = self._reset_performance(['loss', 'entropy', 'ssim', 'psnr'])

    def summary(self):
        l_shape = 'x'.join(str(x) for x in self.latent_shape if x is not None)
        return (f'{self.class_name} : {l_shape}-D latent space @ {self._h.latent_bpf}-bpf '
                f'[{self.count_parameters():,} params]')

    def summary_compact(self):
        return f'{self.class_name} {self.latent_shape[-1]}-D'

    @property
    def model_code(self):
        h = self._h
        parts = [h.rounding, f"Q{'+' if h.train_codebook else '-'}{h.latent_bpf}bpf",
                 'S+' if h.scale_latent else 'S-', f'H+{h.entropy_weight:.2f}']
        return f'{type(self).__name__}-{self.n_features}C/{"_".join(parts)}'


class TwitterDCN(DCN):
    """Compressive autoencoder of Theis et al."""

    def construct_model(self, encoder_key, decoder_key, n_features=32,
                        activation='leaky_relu'):
        if not (isinstance(n_features, int) and 4 <= n_features <= 128):
            raise ValueError(f'n_features must be an integer in [4, 128], got {n_features!r}')
        if activation not in ops.ACTIVATIONS:
            raise ValueError(f'Unsupported activation {activation!r}')
        self.n_features = n_features
        self._h.add({'n_features': (32, int), 'activation': ('leaky_relu', str)})
        self._h.update(n_features=n_features, activation=activation)
        return (TwitterEncoder(n_features, activation, encoder_key),
                TwitterDecoder(n_features, activation, decoder_key))


# Agreement of two float32 runs of the codec on the same image (the card and
# the CPU, or the port and the JAX reference). The encoder's convolutions sum
# in another order, so a latent value within a float32 rounding of the
# midpoint of two codewords can land on the other one: at most
# MAX_LATENT_FLIP_SHARE of the latent's codeword indices may differ. The same
# latent decoded by both runs agrees to MAX_DECODE_DIFF on the [0, 1] scale.
# Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W) against its
# CPU, one 512x768 request of the 32c codec: 0 of 196,608 indices differ,
# and the same latent decodes to within 1.43e-6; the bounds allow about 20
# flipped indices in such a request and 7x the decode difference.
MAX_LATENT_FLIP_SHARE = 1e-4
MAX_DECODE_DIFF = 1e-5


def compare_latents(z, z_ref, codebook):
    """Hold a quantized latent against a reference run's: the share of
    codeword indices that differ. Raises AssertionError beyond
    ``MAX_LATENT_FLIP_SHARE``; returns {'flipped', 'n', 'share'}."""
    codebook = torch.as_tensor(codebook, dtype=torch.float32)

    def indices(t):
        t = torch.as_tensor(t, dtype=torch.float32, device='cpu').reshape(-1, 1)
        return (t - codebook).abs().argmin(dim=1)
    if tuple(z.shape) != tuple(z_ref.shape):
        raise AssertionError(f'latents {tuple(z.shape)} vs {tuple(z_ref.shape)}')
    flipped = int((indices(z) != indices(z_ref)).sum())
    report = {'flipped': flipped, 'n': int(np.prod(z.shape)),
              'share': flipped / int(np.prod(z.shape))}
    if report['share'] > MAX_LATENT_FLIP_SHARE:
        raise AssertionError(f'latents disagree: {report}')
    return report


def compare_decodes(y, y_ref):
    """Hold an image decoded from a latent against a reference run's decode of
    the same latent: max |Δ| <= ``MAX_DECODE_DIFF``. Returns the max."""
    diff = float((torch.as_tensor(y, device='cpu').double()
                  - torch.as_tensor(y_ref, device='cpu').double()).abs().max())
    if not diff <= MAX_DECODE_DIFF:
        raise AssertionError(f'decoded images differ by {diff}')
    return diff
