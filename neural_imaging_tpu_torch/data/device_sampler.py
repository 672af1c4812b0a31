"""
Device-resident training data with patch sampling on the device: port of
``neural_imaging_tpu/data/device_sampler.py``.

The whole training set is copied to the device once, quantized (the uint16
RAW stacks as int16 bit patterns, the uint8 RGB images as they are). Each
call draws image indices and even coordinates from a ``torch.Generator`` on
the device, seeded from (seed, step), and gathers the patches with one
advanced-indexing read per tensor: no host work and no copy per step.

``discard='flat'`` follows the reference: draw ``oversample`` x batch
candidates, score those with variance ≥ ``FLAT_VARIANCE_THRESHOLD`` by 1 + u
(u uniform) and the others by their variance, and keep the ``batch`` best.
``jax.lax.top_k`` breaks ties by the lower index and ``torch.topk`` promises
no order, so the ranking is a stable sort by (−score, index): flat images,
whose candidates tie at variance 0, keep the first candidates drawn.
"""
import numpy as np
import torch

from neural_imaging_tpu_torch.utils.device import resolve_device

FLAT_VARIANCE_THRESHOLD = 0.01  # the 'flat' policy of loading.sample_patch


class DeviceSampler:
    """Copies a Dataset's training images to ``device`` once; ``sampler(step)``
    → a quantized batch ('xy' → (raw, rgb); 'x' → raw; 'y' → rgb)."""

    def __init__(self, data, batch_size, rgb_patch_size, discard='flat', oversample=2,
                 seed=0, device='cuda'):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.rgb_patch_size = rgb_patch_size
        self.raw_patch_size = rgb_patch_size // 2
        self.discard = discard if 'y' in data._loaded_data else None
        self.oversample = max(1, int(oversample)) if self.discard else 1
        self.seed = seed
        self._loaded = data._loaded_data
        train = data.data['training']
        self._X = (torch.from_numpy(train['x'].view('int16')).to(self.device)
                   if 'x' in self._loaded else None)
        self._Y = torch.from_numpy(train['y']).to(self.device) if 'y' in self._loaded else None
        ref = train['y'] if 'y' in self._loaded else train['x']
        self.n_images = ref.shape[0]
        if 'y' in self._loaded:
            self.H, self.W = train['y'].shape[1:3]
        else:
            self.H, self.W = (2 * d for d in train['x'].shape[1:3])
        if self.H < rgb_patch_size or self.W < rgb_patch_size:
            raise ValueError(f'Images ({self.H}x{self.W}) smaller than the '
                             f'requested patch ({rgb_patch_size})')
        self._generator = torch.Generator(device=self.device)
        self._offsets = torch.arange(rgb_patch_size, device=self.device)

    def signature(self):
        """What makes two samplers draw batches of one form."""
        return (self.batch_size, self.rgb_patch_size, self.discard, self.oversample,
                self._loaded, self.n_images, self.H, self.W)

    def draw(self, step):
        """The candidate draws of ``step``: image indices, even y and x
        coordinates of the RGB patches (M,) and the uniform tie-breaks u (M,),
        M = oversample x batch, on the device."""
        M, P = self.batch_size * self.oversample, self.rgb_patch_size
        # (seed, step) mixed into 32 bits: the CPU generator keeps only those
        g = self._generator.manual_seed(
            int(np.random.SeedSequence([self.seed, step]).generate_state(1)[0]))
        idx = torch.randint(0, self.n_images, (M,), generator=g, device=self.device)
        yy = 2 * torch.randint(0, (self.H - P) // 2 + 1, (M,), generator=g, device=self.device)
        xx = 2 * torch.randint(0, (self.W - P) // 2 + 1, (M,), generator=g, device=self.device)
        u = torch.rand(M, generator=g, device=self.device)
        return idx, yy, xx, u

    def _gather(self, images, idx, yy, xx, size):
        rows = (yy[:, None] + self._offsets[:size])[:, :, None]
        cols = (xx[:, None] + self._offsets[:size])[:, None, :]
        return images[idx[:, None, None], rows, cols]

    def sample(self, idx, yy, xx, u):
        """The batch of given candidate draws (see :meth:`draw`): (raw, rgb),
        uint16 (N, r, r, 4) and uint8 (N, 2r, 2r, 3), either None when not
        loaded."""
        B, P, R = self.batch_size, self.rgb_patch_size, self.raw_patch_size
        rgb = None
        if self.discard and len(idx) > B:
            rgb = self._gather(self._Y, idx, yy, xx, P)
            var = torch.var(rgb.to(torch.float32) / 255.0, dim=(1, 2, 3), unbiased=False)
            score = torch.where(var >= FLAT_VARIANCE_THRESHOLD, 1.0 + u, var)
            keep = torch.sort(-score, stable=True).indices[:B]
            idx, yy, xx, rgb = idx[keep], yy[keep], xx[keep], rgb[keep]
        else:
            idx, yy, xx = idx[:B], yy[:B], xx[:B]
            if self._Y is not None:
                rgb = self._gather(self._Y, idx, yy, xx, P)
        raw = (self._gather(self._X, idx, yy // 2, xx // 2, R).view(torch.uint16)
               if self._X is not None else None)
        return raw, rgb

    def __call__(self, step):
        """The batch of a training step, deterministic in (seed, step)."""
        raw, rgb = self.sample(*self.draw(step))
        if self._loaded == 'xy':
            return raw, rgb
        return rgb if self._loaded == 'y' else raw

    def epoch_steps(self):
        """Steps per epoch: the host path's batches per epoch."""
        return max(1, self.n_images // self.batch_size)
