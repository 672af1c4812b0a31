"""
Model shell and checkpoint I/O in the JAX package's format.

A checkpoint is ``<dir>/<class>.npz`` of flax parameter paths (``conv0/kernel``,
``head/bias``, …) with HWIO conv kernels, (kh, kw, in, out) transposed-conv
kernels and Dense kernels of shape (in, out).
:func:`convert_params` turns such a file into a PyTorch ``state_dict``; that is
how weights trained by the JAX package are carried into the port, and
:func:`flax_params` is its inverse, with which the port writes checkpoints
that the JAX package loads.
:func:`restore` builds a model from a training directory or a preset name,
as the JAX package's ``models.base.restore`` does.
"""
import ast
import json
import math
import os
from pathlib import Path

import numpy as np
import torch
from torch import nn

from neural_imaging_tpu_torch.utils import utils
from neural_imaging_tpu_torch.utils.device import resolve_device
from neural_imaging_tpu_torch.utils.paramspec import ParamSpec
from neural_imaging_tpu_torch.utils.utils import logger

REPO_ROOT = Path(__file__).resolve().parents[2]
PRESETS_ROOT = REPO_ROOT / 'config' / 'presets'
# A DCN's training log (progress.json) nests the codec's {model, args} here
LOG_KEY = 'codec'


def restore(dir_name, module, patch_size=None, device='cuda'):
    """Restore a trained model from a training directory or a preset name.

    A name that is not a directory is looked up in
    ``config/presets/<module's last name>.json`` (e.g. ``compression.json``:
    ``'32c'`` → ``data/models/dcn/baselines/32c``, relative to the repo
    root). The last ``*.json`` log found under the directory names the class
    (``training_log['model']``, nested under ``LOG_KEY`` where the log has
    it) and its constructor arguments (``'args'``); the model is built from
    ``module`` with those and ``patch_size`` on ``device``, and its weights
    are loaded."""
    if dir_name is None:
        raise ValueError('model directory cannot be None')
    if not os.path.exists(dir_name):
        preset_file = PRESETS_ROOT / f"{module.__name__.split('.')[-1]}.json"
        if not preset_file.is_file():
            raise ValueError(f'Directory {dir_name} does not exist (presets not available)!')
        presets = json.loads(preset_file.read_text())
        if dir_name not in presets:
            raise ValueError(f'Directory {dir_name} does not exist & key not found in presets!')
        dir_name = os.path.join(REPO_ROOT, presets[dir_name])

    training_log_path = None
    for filename in Path(dir_name).glob('**/*.json'):
        training_log_path = filename
    if training_log_path is None:
        raise FileNotFoundError(f'Could not find a training log (JSON file) in {dir_name}')
    training_log = json.loads(training_log_path.read_text())
    training_log = training_log.get(LOG_KEY, training_log)

    parameters = _parse_tuple_args(dict(training_log['args'] or {}))
    parameters['patch_size'] = patch_size
    model = getattr(module, training_log['model'])(**parameters, device=device)
    model.load_model(str(dir_name))
    return model


def _parse_tuple_args(parameters):
    """JSON stores tuple arguments as strings like '(32, 32)'; parse them back."""
    out = {}
    for k, v in parameters.items():
        if isinstance(v, str) and len(v) >= 2 and v[0] == '(' and v[-1] == ')':
            try:
                out[k] = ast.literal_eval(v)
                continue
            except (ValueError, SyntaxError):
                pass
        out[k] = v
    return out


def flax_default_init(module, fan_in, generator):
    """flax's default init of a conv or dense ``module``: LeCun-normal weight
    (truncated at 2σ), zero bias (where it has one)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        if module.bias is not None:
            module.bias.zero_()
    return module


def load_flax_npz(filename):
    """{flax path: array} of a JAX-format ``.npz`` checkpoint."""
    with np.load(filename) as z:
        return {k: z[k] for k in z.files}


def convert_params(flax_flat, transposed=()):
    """Flat flax parameters → PyTorch ``state_dict``.

    Paths map '/' → '.', and a last component 'kernel' becomes 'weight'.
    A 4-D array is an HWIO conv kernel and becomes OIHW, unless its
    ``state_dict`` name is in ``transposed``: a flax ``ConvTranspose``
    kernel (kh, kw, in, out), which flax correlates with the dilated input
    unflipped (``transpose_kernel=False``) where
    ``F.conv_transpose2d`` convolves, so it is flipped in both spatial axes
    and becomes (in, out, kh, kw). A 2-D array is a Dense kernel (in, out)
    and becomes (out, in); other arrays pass unchanged (a 0-d
    ``latent_scale`` or ``alpha``, a 1-d ``codebook``). Values are float32
    tensors on the CPU."""
    state = {}
    for path, value in flax_flat.items():
        parts = path.split('/')
        if parts[-1] == 'kernel':
            parts[-1] = 'weight'
        name = '.'.join(parts)
        t = torch.tensor(np.asarray(value, dtype=np.float32))
        if t.ndim == 4 and name in transposed:
            t = t.flip(0, 1).permute(2, 3, 0, 1)
        elif t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        elif t.ndim == 2:
            t = t.T
        state[name] = t.contiguous()
    return state


def flax_params(named_parameters, transposed=()):
    """PyTorch parameters → flat flax parameters, the inverse of
    :func:`convert_params`: '.' → '/', a last component 'weight' becomes
    'kernel', 4-D OIHW kernels become HWIO, the (in, out, kh, kw) kernels
    named in ``transposed`` flax's flipped (kh, kw, in, out), and 2-D (out,
    in) kernels (in, out). Values are float32 numpy arrays."""
    flat = {}
    for name, value in named_parameters:
        parts = name.split('.')
        if parts[-1] == 'weight':
            parts[-1] = 'kernel'
        t = value.detach().to('cpu', torch.float32)
        if t.ndim == 4 and name in transposed:
            t = t.permute(2, 3, 0, 1).flip(0, 1)
        elif t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        elif t.ndim == 2:
            t = t.T
        flat['/'.join(parts)] = t.contiguous().numpy()
    return flat


def transposed_kernels(module):
    """``state_dict`` names of the weights of ``module``'s transposed convs."""
    return frozenset(f'{name}.weight' for name, m in module.named_modules()
                     if isinstance(m, nn.ConvTranspose2d))


class TorchModel:
    """Shell around an ``nn.Module`` core: device placement, naming, the
    history of metrics (``performance``) and checkpoints in the JAX
    package's format. The core runs in eval mode. Subclasses that record
    hyper-parameters as the JAX package does keep them in ``self._h``, a
    ``ParamSpec``."""

    def __init__(self, module, device='cuda'):
        self.device = resolve_device(device)
        self.module = None if module is None else module.to(self.device).eval()
        self.reset_performance_stats()

    # -- performance stats ------------------------------------------------------

    @staticmethod
    def _reset_performance(metric_names):
        return {k: {'training': [], 'validation': []} for k in metric_names}

    def reset_performance_stats(self):
        self.performance = self._reset_performance(['loss'])

    def log_metric(self, metric, scope, value, raw=False):
        """Append ``value`` (its mean, unless a number or ``raw``) to the
        history of ``metric`` in ``scope`` ('training' or 'validation')."""
        if not raw:
            if torch.is_tensor(value):
                value = value.detach().cpu().numpy()
            value = float(value) if utils.is_number(value) else float(np.mean(np.asarray(value)))
        self.performance[metric][scope].append(value)

    def pop_metric(self, metric, scope):
        return self.performance[metric][scope][-1]

    # -- naming -----------------------------------------------------------------------

    @property
    def class_name(self):
        return type(self).__name__

    @property
    def scoped_name(self):
        return type(self).__name__.lower()

    @property
    def model_code(self):
        raise NotImplementedError()

    def _spec(self):
        h = getattr(self, '_h', None)
        return h if isinstance(h, ParamSpec) else None

    def get_hyperparameters(self):
        return self._spec().to_json() if self._spec() else None

    def summary(self):
        return f'{self.class_name} model [{self.count_parameters():,} parameters]'

    def summary_compact(self):
        return self.class_name

    def __repr__(self):
        extra = utils.join_args(self._spec().changed_params()) if self._spec() else ''
        return f'{self.class_name}({extra})'

    # -- parameters and checkpoints ------------------------------------------------

    def count_parameters(self):
        return sum(p.numel() for p in self.module.parameters())

    def checkpoint(self):
        """{flax path: float32 array} of the weights, as ``save_model`` writes them."""
        return flax_params(self.module.named_parameters(), transposed_kernels(self.module))

    def save_model(self, dirname, epoch=0, save_args=False, quiet=False):
        """Write ``<dirname>[/<scoped name>]/<class>.npz`` in the JAX package's
        format (and with ``save_args`` the ``<class>.json`` of the class and
        its hyper-parameters). ``epoch`` is accepted for the reference's
        signature; the file holds the current weights."""
        if not dirname.endswith(self.scoped_name):
            dirname = os.path.join(dirname, self.scoped_name)
        os.makedirs(dirname, exist_ok=True)
        stem = os.path.join(dirname, self.class_name.lower())
        if not quiet:
            logger.info('> %s --> %s.npz %s', self.class_name, stem, 'JSON' if save_args else '')
        np.savez(stem + '.npz', **self.checkpoint())
        if save_args:
            with open(stem + '.json', 'w') as f:
                json.dump({'model': self.class_name, 'args': self.get_hyperparameters()},
                          f, indent=4)

    def load_model(self, dirname, quiet=False):
        """Load ``<dirname>[/<scoped name>]/<class>.npz`` (strict: every
        parameter present, no extra ones) and reset the metric history."""
        if not dirname.rstrip('/').endswith(self.scoped_name):
            dirname = os.path.join(dirname, self.scoped_name)
        filename = os.path.join(dirname, f'{self.class_name.lower()}.npz')
        if not quiet:
            logger.info('> %s <-- %s', self.class_name, filename)
        self.module.load_state_dict(convert_params(load_flax_npz(filename),
                                                   transposed_kernels(self.module)), strict=True)
        self.reset_performance_stats()
