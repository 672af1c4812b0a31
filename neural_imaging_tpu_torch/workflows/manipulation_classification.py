"""
The manipulation-classification forward path:

    raw → INet → rgb → [native + K manipulations] → 2x pool → JPEG (soft) → FAN → probs

Port of the forward part of
``neural_imaging_tpu/workflows/manipulation_classification.py`` at fixed
manipulation strengths, float32 throughout. Training (losses, Adam),
randomized strengths and qualities, the DCN channel, bilinear or no
downsampling and the bf16 knobs are not ported yet.
"""
import json
import os

import torch

from neural_imaging_tpu_torch.models import forensics, jpeg as jpeg_models, pipelines
from neural_imaging_tpu_torch.ops import manipulations as manips
from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.utils.device import resolve_device

# the reference's class order of the manipulations
CANONICAL_ORDER = ('sharpen', 'resample', 'gaussian', 'jpeg')
# the channel's compression_params that the port's JPEG takes
JPEG_PARAMS = ('quality', 'codec', 'trainable', 'rng')

# Agreement of two float32 runs of the full-width path on the same raw batch
# (GPU and CPU, or the port and the JAX reference). Summation order alone moves
# probabilities by ~1e-4 at a 128-px FAN input; a dJPEG coefficient that flips
# by one q step between the two runs moves its row by a few 1e-3 (chip_smoke.py,
# an H100 against the CPU on 20 raw 128-px patches: up to 4.0e-3).
MAX_PROBABILITY_DIFF = 1e-2
DECISION_MARGIN = 2e-2


def compare_probabilities(p, p_ref):
    """Hold class probabilities against a reference run: every entry within
    ``MAX_PROBABILITY_DIFF``, and the same decision in every row where the
    reference's two top classes are more than ``DECISION_MARGIN`` apart.
    Raises AssertionError; returns {'max_abs_diff', 'decided_rows', 'rows'}."""
    p = torch.as_tensor(p, dtype=torch.float64, device='cpu')
    p_ref = torch.as_tensor(p_ref, dtype=torch.float64, device='cpu')
    if p.shape != p_ref.shape:
        raise AssertionError(f'probabilities {tuple(p.shape)} vs {tuple(p_ref.shape)}')
    diff = float((p - p_ref).abs().max())
    top2 = p_ref.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > DECISION_MARGIN
    same = p.argmax(dim=1) == p_ref.argmax(dim=1)
    report = {'max_abs_diff': diff, 'decided_rows': int(decided.sum()), 'rows': p.shape[0]}
    if not diff <= MAX_PROBABILITY_DIFF or not bool(same[decided].all()):
        raise AssertionError(f'probabilities disagree: {report}, '
                             f'{int((~same[decided]).sum())} decided rows differ')
    return report


class ManipulationClassification:

    def __init__(self, nip_model='INet', manipulations=None, distribution=None,
                 fan_args=None, raw_patch_size=128, nip_args=None, device='cuda'):
        """
        :param nip_model: NIP class name ('INet' is the one ported)
        :param manipulations: list of '<name>[:strength]' specs
        :param distribution: {'downsampling': 'pool[:factor]', 'compression': 'jpeg',
                              'compression_params': {'quality': int, 'codec': 'soft'|…,
                                                     'trainable': bool}}
        :param fan_args: FAN constructor arguments other than n_classes/patch_size
        :param raw_patch_size: RAW patch size (RGB patches are twice as large)
        :param device: where the models live and the forward runs
        """
        if raw_patch_size < 16 or raw_patch_size > 512:
            raise ValueError(f'The patch size ({raw_patch_size}) looks incorrect')
        self.device = resolve_device(device)
        self.raw_patch_size = raw_patch_size

        self._distribution = {
            'downsampling': 'pool:2',
            'compression': 'jpeg',
            'compression_params': {'quality': 50, 'codec': 'soft'},
        }
        if distribution is not None:
            self._distribution.update(distribution)
        if not self._distribution['downsampling'].startswith('pool'):
            raise NotImplementedError(
                f"downsampling {self._distribution['downsampling']!r} is not ported; use 'pool'")
        if self._distribution['compression'] != 'jpeg':
            raise NotImplementedError(
                f"compression {self._distribution['compression']!r} is not ported; use 'jpeg'")
        params = dict(self._distribution.get('compression_params') or {})
        unknown = sorted(set(params) - set(JPEG_PARAMS))
        if unknown:
            raise NotImplementedError(f'JPEG channel parameters {unknown} are not ported; '
                                      f'the port takes {list(JPEG_PARAMS)}')
        self.codec = jpeg_models.JPEG(**params, device=self.device)
        if not isinstance(self.codec.quality, (int, float)):
            raise NotImplementedError('randomized channel JPEG quality is not ported')

        if nip_model != 'INet':
            raise NotImplementedError(f'NIP {nip_model!r} is not ported; use INet')
        self.nip = pipelines.INet(patch_size=raw_patch_size, device=self.device,
                                  **(nip_args or {}))

        self._strengths = dict(manips.DEFAULT_STRENGTHS)
        requested = []
        for m in manipulations or list(CANONICAL_ORDER):
            name, *strength = m.split(':')
            if name not in self._strengths:
                raise NotImplementedError(f'manipulation {name!r} is not ported; '
                                          f'available: {sorted(self._strengths)}')
            if name not in requested:
                requested.append(name)
            if strength:
                self._strengths[name] = float(strength[-1])
        self._operations = [name for name in CANONICAL_ORDER if name in requested]
        self.forensics_classes = ['native'] + [
            f'{name}:{self._strengths[name]:g}' for name in self._operations]

        self.fan = forensics.FAN(n_classes=self.n_classes,
                                 patch_size=2 * raw_patch_size // self.downsampling_factor,
                                 device=self.device, **(fan_args or {}))

    @classmethod
    def restore(cls, run_dir, raw_patch_size=128, device='cuda'):
        """Rebuild the flow of a finished JAX run directory (``training.json`` +
        ``models/{fan,inet}/*.npz``) with its weights."""
        with open(os.path.join(run_dir, 'training.json')) as f:
            log = json.load(f)
        fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
        flow = cls(log['nip']['model'],
                   manipulations=[m for m in log['manipulations'] if m != 'native'],
                   distribution=log['distribution'], fan_args=fan_args,
                   raw_patch_size=raw_patch_size, nip_args=log['nip'].get('args'),
                   device=device)
        models_dir = os.path.join(run_dir, 'models')
        flow.fan.load_model(os.path.join(models_dir, 'fan'))
        nip_dir = os.path.join(models_dir, flow.nip.scoped_name)
        if os.path.isdir(nip_dir) and flow.nip.count_parameters() > 0:
            flow.nip.load_model(nip_dir)
        return flow

    @property
    def n_classes(self):
        return len(self._operations) + 1

    @property
    def downsampling_factor(self):
        ds = self._distribution['downsampling']
        return int(ds.split(':')[-1]) if ':' in ds else 2

    # -- the forward path on NCHW tensors --------------------------------------

    def _manipulate(self, batch_Y):
        """(K+1)-way batch expansion: [native] + each manipulation, class-major."""
        return torch.cat([batch_Y] + [manips.MANIPULATIONS[name](batch_Y, self._strengths[name])
                                      for name in self._operations], dim=0)

    def _downsample(self, batch):
        return ops.avg_pool(batch, self.downsampling_factor)

    def _compress(self, batch):
        """The channel through the codec's own q-tables (trainable or not), as
        the reference runs a trainable codec's."""
        tables = self.codec._model.params
        y, _ = jpeg_models.jpeg_forward_nchw(batch, tables['q_mtx_luma'], tables['q_mtx_chroma'],
                                             rounding=self.codec.codec)
        return y

    def _forward(self, batch_x):
        batch_Y = self.nip.module(batch_x)
        batch_c = self._downsample(self._manipulate(batch_Y))
        batch_C = self._compress(batch_c)
        probabilities = self.fan.module(batch_C)
        return batch_Y, batch_c, batch_C, probabilities

    # -- public API ----------------------------------------------------------------

    def run_workflow(self, batch_x):
        """NHWC RAW batch (N, h, w, 4) in [0,1] → (batch_Y, batch_c, batch_C,
        entropy, probabilities): the developed RGB, the pooled expanded batch
        and its JPEG (NHWC views), 0 for the JPEG channel's entropy, and the
        class probabilities ((K+1)·N, K+1), rows class-major."""
        x = torch.as_tensor(batch_x, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            batch_Y, batch_c, batch_C, probs = self._forward(
                x.permute(0, 3, 1, 2).contiguous())
        nhwc = [t.permute(0, 2, 3, 1) for t in (batch_Y, batch_c, batch_C)]
        return (*nhwc, torch.zeros((), device=self.device), probs)

    def run_workflow_to_decisions(self, batch_x):
        """Predicted class of every row of :meth:`run_workflow`, as a numpy array."""
        probs = self.run_workflow(batch_x)[-1]
        return probs.argmax(dim=1).cpu().numpy()
