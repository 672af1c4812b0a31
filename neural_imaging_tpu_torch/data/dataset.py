"""
In-memory patch-sampling dataset for RAW → RGB training: port of
``neural_imaging_tpu/data/dataset.py``.

Full-resolution images are loaded once (uint16 RAW stacks, uint8 RGB);
validation patches are drawn at construction and training patches per
batch, both from one ``np.random.default_rng(randomize)`` consumed in the
reference's order, so the two packages draw the same patches from the same
directory (the split's shuffle has a generator of its own, as there).
``validation_tensors(device)`` takes the place of the reference's
``device_put_validation``.
"""
import os

import numpy as np
import torch

from neural_imaging_tpu_torch.data import loading
from neural_imaging_tpu_torch.data.loading import sample_patch

_SEARCH_ROOTS = ('data/raw/training_data', 'data/rgb')
RAW_SCALE, RGB_SCALE = np.float32(2 ** 16 - 1), np.float32(2 ** 8 - 1)


class Dataset:

    def __init__(self, data_directory, *, randomize=2468, load='xy', n_images=120,
                 v_images=30, val_rgb_patch_size=128, val_n_patches=1,
                 val_discard='flat-aggressive'):
        if load not in ('xy', 'x', 'y'):
            raise ValueError(f"load must be one of 'xy', 'x', 'y' — got {load!r}")

        if not os.path.isdir(data_directory):
            if '/' in data_directory or '\\' in data_directory:
                raise ValueError(f'Cannot find the data directory: {data_directory}')
            for root in _SEARCH_ROOTS:
                candidate = os.path.join(root, data_directory)
                if os.path.isdir(candidate):
                    data_directory = candidate
                    break
            else:
                raise ValueError(f'Cannot find the data directory: {data_directory}')

        self.files = {}
        self._loaded_data = load
        self._data_directory = data_directory
        self._counts = (n_images, v_images, val_n_patches)
        self._val_discard = val_discard
        self._rng = np.random.default_rng(randomize if randomize else None)

        self.files['training'], self.files['validation'] = loading.discover_images(
            data_directory, randomize=randomize, n_images=n_images, v_images=v_images)

        self.data = {
            'training': loading.load_images(self.files['training'], data_directory, load=load),
            'validation': loading.load_patches(
                self.files['validation'], data_directory, patch_size=val_rgb_patch_size // 2,
                n_patches=val_n_patches, load=load, discard=val_discard, rng=self._rng),
        }

        if 'y' in self.data['training']:
            self.H, self.W = self.data['training']['y'].shape[1:3]
        else:
            self.H, self.W = (2 * d for d in self.data['training']['x'].shape[1:3])

    def __getitem__(self, key):
        if key in ('training', 'validation'):
            return self.data[key]
        raise KeyError(f'Key: {key} not found!')

    # -- batch sampling -------------------------------------------------------------

    def next_training_batch(self, batch_id, batch_size, rgb_patch_size, discard='flat',
                            max_attempts=25, quantized=False):
        """Sample a batch of aligned training patches (float32 in [0,1]), or
        with ``quantized=True`` the stored uint16 RAW / uint8 RGB values
        (4x less to copy; the flow normalizes them on the device)."""
        if discard is not None and 'y' not in self.data['training']:
            raise ValueError('Cannot discard patches if RGB data is not loaded.')
        if (batch_id + 1) * batch_size > len(self.files['training']):
            raise ValueError('Not enough images for the requested batch_id & batch_size')

        raw_patch_size = rgb_patch_size // 2
        x_dtype = np.uint16 if quantized else np.float32
        y_dtype = np.uint8 if quantized else np.float32
        batch_x = (np.zeros((batch_size, raw_patch_size, raw_patch_size, 4), dtype=x_dtype)
                   if 'x' in self._loaded_data else None)
        batch_y = (np.zeros((batch_size, rgb_patch_size, rgb_patch_size, 3), dtype=y_dtype)
                   if 'y' in self._loaded_data else None)

        for b in range(batch_size):
            bid = batch_id * batch_size + b
            if 'y' in self._loaded_data:
                current_rgb = self.data['training']['y'][bid]
            else:
                # RAW-only dataset: sample coordinates from an equivalent RGB canvas
                current_rgb = np.empty((self.H, self.W, 0), dtype=np.uint8)
            xx, yy = sample_patch(current_rgb, rgb_patch_size, discard, max_attempts, rng=self._rng)
            rx, ry = xx // 2, yy // 2
            if batch_x is not None:
                raw = self.data['training']['x'][bid]
                patch = raw[ry:ry + raw_patch_size, rx:rx + raw_patch_size]
                batch_x[b] = patch if quantized else patch / RAW_SCALE
            if batch_y is not None:
                patch = current_rgb[yy:yy + rgb_patch_size, xx:xx + rgb_patch_size]
                batch_y[b] = patch if quantized else patch / RGB_SCALE

        if self._loaded_data == 'xy':
            return batch_x, batch_y
        return batch_y if self._loaded_data == 'y' else batch_x

    def next_validation_batch(self, batch_id, batch_size):
        rgb_patch = self.rgb_patch_size
        sel = slice(batch_id * batch_size, (batch_id + 1) * batch_size)
        batch_x = batch_y = None
        if 'x' in self._loaded_data:
            batch_x = self.data['validation']['x'][sel].astype(np.float32) / RAW_SCALE
            if batch_x.shape[1] != rgb_patch // 2:
                raise ValueError(f'RAW validation patches of {batch_x.shape[1]} px, '
                                 f'expected {rgb_patch // 2}')
        if 'y' in self._loaded_data:
            batch_y = self.data['validation']['y'][sel].astype(np.float32) / RGB_SCALE
        if self._loaded_data == 'xy':
            return batch_x, batch_y
        return batch_y if self._loaded_data == 'y' else batch_x

    def epoch_batches(self, batch_size, rgb_patch_size, discard='flat'):
        """A whole epoch of training batches stacked as (n_batches, batch, ...)."""
        n_batches = self.count_training // batch_size
        outs = [self.next_training_batch(b, batch_size, rgb_patch_size, discard)
                for b in range(n_batches)]
        if self._loaded_data == 'xy':
            xs = np.stack([o[0] for o in outs])
            ys = np.stack([o[1] for o in outs])
            return xs, ys
        return np.stack(outs)

    # -- properties -----------------------------------------------------------------

    def is_raw_and_rgb(self):
        return len(self._loaded_data) == 2

    @property
    def rgb_patch_size(self):
        if 'y' in self._loaded_data:
            return self.data['validation']['y'].shape[1]
        return 2 * self.data['validation']['x'].shape[1]

    @property
    def count_training(self):
        return self.data['training'][self._loaded_data[0]].shape[0]

    @property
    def count_validation(self):
        return self.data['validation'][self._loaded_data[0]].shape[0]

    @property
    def loaded_data(self):
        return {'xy': 'raw+rgb', 'y': 'rgb', 'x': 'raw'}[self._loaded_data]

    def __repr__(self):
        return (f'Dataset("{self._data_directory}", load="{self._loaded_data}", '
                f'n_images={self._counts[0]}, v_images={self._counts[1]}, '
                f'val_n_patches={self._counts[2]}, discard="{self._val_discard}")')

    def summary(self):
        valid_label = '' if self._val_discard is None else f', {self._val_discard}'
        return (f'Dataset[{os.path.split(self._data_directory)[-1]},{self.loaded_data}] : '
                f'{self.count_training} train. images + {self.count_validation} valid. '
                f'patches ({self.rgb_patch_size} px{valid_label})')

    def details(self):
        label = [self.summary()]
        for k, name in zip('xy', ['RAW', 'RGB']):
            if k in self._loaded_data:
                label.append(f'{name} -> training {self.data["training"][k].shape} '
                             f'+ validation {self.data["validation"][k].shape}')
        return '\n'.join(label)

    def shapes(self):
        out = {'path': self._data_directory}
        for k in self._loaded_data:
            out[f'training/{k}'] = self.data['training'][k].shape
            out[f'validation/{k}'] = self.data['validation'][k].shape
        return out

    # -- generators -----------------------------------------------------------------

    def get_training_generator(self, batch_size, rgb_patch_size, discard='flat',
                               quantized=False):
        for batch_id in range(self.count_training // batch_size):
            yield self.next_training_batch(batch_id, batch_size, rgb_patch_size,
                                           discard, quantized=quantized)

    def get_validation_generator(self, batch_size):
        for batch_id in range(self.count_validation // batch_size):
            yield self.next_validation_batch(batch_id, batch_size)

    # -- device placement -----------------------------------------------------------

    def validation_tensors(self, device):
        """The whole validation set as float32 tensors in [0, 1] on ``device``:
        (raw, rgb) for 'xy', else the one that is loaded."""
        out = tuple(torch.from_numpy(self.data['validation'][k].astype(np.float32)
                                     / (RAW_SCALE if k == 'x' else RGB_SCALE)).to(device)
                    for k in self._loaded_data)
        return out if len(out) > 1 else out[0]
