"""
The manipulation-classification path and its joint training step:

    raw → NIP → rgb → [native + K manipulations] → downsample → JPEG (soft) → FAN → probs

Port of ``neural_imaging_tpu/workflows/manipulation_classification.py``:
the forward at fixed or randomized strengths (``run_workflow``),
and ``training_step``, which takes one Adam step of the FAN and the other
trainable parts on cross-entropy plus the NIP's and the channel's weighted
losses. The manipulations are any of the reference's seven (sharpen,
resample, gaussian, jpeg, awgn, gamma, median), in its class order. Every
random draw of a step (manipulation strengths, the channel's quality,
awgn's noise) is made on the device from a ``torch.Generator`` seeded
with ``rng_seed``, so a step never waits on the host; PyTorch cannot
reproduce JAX's PRNG, so parity tests pass the same strengths and noise to
both (``_losses``, ``loss_and_gradients``).
``training_scan`` runs steps on batches that a ``DeviceSampler`` draws on
the device. The NIP is any ported camera ISP (INet, UNet, DNet,
ClassicISP, optionally from its snapshot: ``'UNet:<dir>'``) or ONet, which
passes RGB input through; ``remat`` recomputes the NIP and the
manipulations in the backward pass instead of keeping their activations.
The channel is a JPEG (fixed or trainable q-tables; a 'libjpeg' channel
rounds 'soft' inside the flow, as the reference's does), a learned codec
(``'dcn'``: a ``TwitterDCN`` restored from a directory or preset, its
quantizer on K2 and K3 or K4, trainable as the ``'dcn'`` part with its
rate-distortion loss weighted by λ_dcn) or none. awgn's noise is drawn
before the ``remat`` checkpoint and passed in, so the recomputed forward
adds the same noise (the checkpoint restores the default generators' state,
not the flow's).

Precision, as in the reference: the NIP develops in float32 (its fidelity
loss too); ``channel_dtype`` is the dtype of the manipulation expansion,
the pooling, the channel's output and the FAN's input; the channel's JPEG
and the 'jpeg' manipulation run in float32 through K1 unless
``channel_jpeg_dtype`` / ``manip_jpeg_dtype`` is 'bfloat16', which runs that
codec in bfloat16 through the plane form at 'default' precision.
"""
import json
import os
import warnings

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from neural_imaging_tpu_torch.compression import codec as dcn_codec
from neural_imaging_tpu_torch.models import forensics, jpeg as jpeg_models, pipelines
from neural_imaging_tpu_torch.models.compression import DCN
from neural_imaging_tpu_torch.ops import manipulations as manips
from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.parallel import mesh as mesh_lib
from neural_imaging_tpu_torch.utils import profiling, runtime
from neural_imaging_tpu_torch.utils.device import resolve_device

# the reference's class order of the manipulations
CANONICAL_ORDER = ('sharpen', 'resample', 'gaussian', 'jpeg', 'awgn', 'gamma', 'median')
# the reference's manipulations when none are given
DEFAULT_MANIPULATIONS = ('sharpen', 'resample', 'gaussian', 'jpeg')
# the channel's compression_params that the port's JPEG takes
JPEG_PARAMS = ('quality', 'codec', 'trainable', 'rng')
# candidate strengths of a switched manipulation (resample, median) across its range
N_STRENGTH_CANDIDATES = 8
# the parts a flow may train; the FAN always trains, 'dcn' names the channel's
# trainable slot (the learned codec, or the JPEG q-tables), as in the reference
COMPONENTS = ('fan', 'nip', 'dcn')
# the NIP's fidelity losses the flow takes, as in the reference
NIP_LOSSES = ('L2', 'L1', 'SSIM')

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


# Agreement of two float32 runs of one full-width training step (the GPU and
# the CPU) on the same batch and weights, from ``loss_and_gradients``: the loss
# and each of its parts within MAX_STEP_LOSS_DIFF of the reference's
# (relative), and each trainable part's gradient norm and each leaf's within
# MAX_GRADIENT_NORM_DIFF (relative). A dJPEG coefficient that flips by one q
# step between the two runs moves its rows' probabilities by a few 1e-3
# (MAX_PROBABILITY_DIFF) and their cross-entropy and its gradients with them.
# chip_smoke.py, an H100 against the CPU on 20 raw 128-px patches of the
# m_quality run with the NIP trainable: loss parts within 1.45e-4, gradient
# norms within 3.06e-4; the bounds allow about 7 and 10 times that.
MAX_STEP_LOSS_DIFF = 1e-3
MAX_GRADIENT_NORM_DIFF = 3e-3
# The same for two runs of a bfloat16 step (bench.py's configuration): a
# bfloat16 value whose float32 sum differs by its last bit between the two
# runs may round the other way, by one bfloat16 ulp (2^-8 relative), and the
# FAN's gradients pass through many such roundings.
BF16_STEP_LOSS_DIFF = 1e-2
BF16_GRADIENT_NORM_DIFF = 5e-2


def compare_steps(step, step_ref, max_loss_diff=MAX_STEP_LOSS_DIFF,
                  max_grad_diff=MAX_GRADIENT_NORM_DIFF):
    """Hold (loss, parts, gradients) of ``loss_and_gradients`` against a
    reference run's. Raises AssertionError beyond the bounds (the float32
    ones above by default); returns {'max_loss_rel_diff',
    'max_grad_norm_rel_diff', 'grad_norms', 'grad_norms_ref'} (norms per
    trainable part)."""
    loss, parts, grads = step
    loss_ref, parts_ref, grads_ref = step_ref

    def rel(a, b):
        a, b = float(a), float(b)
        return abs(a - b) / max(abs(b), 1e-30)

    loss_diff = max([rel(loss, loss_ref)] + [rel(parts[k], parts_ref[k]) for k in parts_ref
                                             if float(parts_ref[k]) != 0])
    norms, norms_ref, diffs = {}, {}, {}
    for part, leaves in grads_ref.items():
        leaf_norms = {k: float(torch.linalg.vector_norm(g.double().cpu())) for k, g in
                      grads[part].items()}
        leaf_norms_ref = {k: float(torch.linalg.vector_norm(g.double().cpu())) for k, g in
                          leaves.items()}
        norms[part] = sum(n * n for n in leaf_norms.values()) ** 0.5
        norms_ref[part] = sum(n * n for n in leaf_norms_ref.values()) ** 0.5
        diffs[part] = rel(norms[part], norms_ref[part])
        diffs.update({f'{part}/{k}': rel(leaf_norms[k], leaf_norms_ref[k])
                      for k in leaf_norms_ref})
    worst = max(diffs, key=diffs.get) if diffs else None
    grad_diff = diffs[worst] if diffs else 0.0
    report = {'max_loss_rel_diff': loss_diff, 'max_grad_norm_rel_diff': grad_diff,
              'worst_gradient': worst, 'grad_norms': norms, 'grad_norms_ref': norms_ref}
    if not loss_diff <= max_loss_diff or not grad_diff <= max_grad_diff:
        raise AssertionError(f'training steps disagree: {report}')
    return report


class ManipulationClassification:

    # the data-parallel context of the steps (``DataParallel.distribute``)
    parallel = None

    @profiling.spanned('build')
    def __init__(self, nip_model='INet', manipulations=None, distribution=None,
                 fan_args=None, trainable=None, raw_patch_size=128, loss_metric='L2',
                 rng_seed=0, nip_args=None, channel_dtype='float32', channel_jpeg_dtype=None,
                 manip_jpeg_dtype=None, pool_impl='window', remat=False, device='cuda'):
        """
        :param nip_model: '<NIP class>[:snapshot dir]' (INet, UNet, DNet or
            ClassicISP; or ONet, which takes RGB batches of twice the raw
            patch); a directory loads the NIP's weights from it
        :param manipulations: list of '<name>[:strength]' specs
        :param distribution: {'downsampling': 'pool[:factor]' | 'bilinear' | 'none',
                              'compression': 'jpeg' | 'dcn' | 'none',
                              'compression_params': {'quality': int | (lo, hi) | set,
                                                     'codec': 'soft'|…|'libjpeg', 'trainable': bool}
                                                    or, for 'dcn', {'dirname': directory
                                                    or preset of the codec}}
        :param fan_args: FAN constructor arguments other than n_classes/patch_size
        :param trainable: parts to train besides the FAN: 'nip', 'dcn' (the
            learned codec, or the channel's q-tables when the JPEG is trainable)
        :param raw_patch_size: RAW patch size (RGB patches are twice as large)
        :param loss_metric: the NIP's fidelity loss ('L2', 'L1', 'SSIM')
        :param rng_seed: seeds the host draws (``_sample_strengths``) and the
            device draws of a training step
        :param channel_dtype: 'float32' | 'bfloat16', the distribution
            channel's compute dtype (see the module docstring)
        :param channel_jpeg_dtype: None | 'float32' | 'bfloat16', the
            channel JPEG's compute dtype
        :param manip_jpeg_dtype: None | 'float32' | 'bfloat16', the 'jpeg'
            manipulation's compute dtype
        :param pool_impl: 'window' | 'flat' (``ops.avg_pool`` or
            ``ops.avg_pool_flat``, which round differently in bfloat16)
        :param remat: recompute the NIP and the manipulations (and the
            pooling) in the backward pass rather than keep their activations
            (``torch.utils.checkpoint``): less memory for larger NIPs, at the
            cost of a second forward of that part (a 'jpeg' manipulation then
            launches K1 once more)
        :param device: where the models live and the flow runs
        """
        if raw_patch_size < 16 or raw_patch_size > 512:
            raise ValueError(f'The patch size ({raw_patch_size}) looks incorrect')
        if channel_dtype not in forensics.DTYPES:
            raise ValueError(f'Unsupported channel dtype {channel_dtype}')
        if channel_jpeg_dtype not in (None, 'float32', 'bfloat16'):
            raise ValueError(f'Unsupported channel JPEG dtype {channel_jpeg_dtype}')
        if manip_jpeg_dtype not in (None, 'float32', 'bfloat16'):
            raise ValueError(f'Unsupported manipulation JPEG dtype {manip_jpeg_dtype}')
        if pool_impl not in ('window', 'flat'):
            raise ValueError(f'Unsupported pool_impl {pool_impl}')
        self._channel_dtype = forensics.DTYPES[channel_dtype]
        self._channel_jpeg_bf16 = channel_jpeg_dtype == 'bfloat16'
        self._manip_jpeg_bf16 = manip_jpeg_dtype == 'bfloat16'
        self._pool_impl = pool_impl
        self.remat = remat
        self.device = resolve_device(device)
        self.raw_patch_size = raw_patch_size
        # built as the reference builds it, so that both iterate it in one order
        self._trainable = set(trainable or ())
        self._trainable.add('fan')
        if not self._trainable <= set(COMPONENTS):
            raise ValueError(f'Unknown trainable parts {sorted(self._trainable - set(COMPONENTS))}')

        self._distribution = {
            'downsampling': 'pool:2',
            'compression': 'jpeg',
            'compression_params': {'quality': 50, 'codec': 'soft'},
        }
        if distribution is not None:
            self._distribution.update(distribution)
        ds = self._distribution['downsampling']
        if not (ds.startswith('pool') or ds in ('bilinear', 'none')):
            raise ValueError(f'Unsupported channel down-sampling {ds!r}')
        compression = self._distribution['compression']
        if compression not in ('jpeg', 'dcn', 'none'):
            raise ValueError(f'Unsupported channel compression {compression}')
        self.codec = None
        if compression == 'dcn':
            self.codec = dcn_codec.restore(
                self._distribution['compression_params']['dirname'],
                patch_size=2 * raw_patch_size // self.downsampling_factor, device=self.device)
        elif compression == 'jpeg':
            params = dict(self._distribution.get('compression_params') or {})
            unknown = sorted(set(params) - set(JPEG_PARAMS))
            if unknown:
                raise NotImplementedError(f'JPEG channel parameters {unknown} are not taken: '
                                          f'the JPEG takes {list(JPEG_PARAMS)}, as the '
                                          f"reference's does")
            self.codec = jpeg_models.JPEG(**params, device=self.device)
        if 'dcn' in self._trainable and not self._codec_is_trainable():
            raise ValueError('The current codec does not appear to be trainable!')

        nip_model, _, nip_pretrained = nip_model.partition(':')
        if nip_model not in pipelines.supported_models:
            raise ValueError(f'Invalid NIP model ({nip_model})! '
                             f'Available: {pipelines.supported_models}')
        if loss_metric not in NIP_LOSSES:
            raise ValueError(f'Invalid loss metric ({loss_metric})!')
        self.nip = getattr(pipelines, nip_model)(patch_size=raw_patch_size,
                                                 loss_metric=loss_metric, device=self.device,
                                                 **(nip_args or {}))
        if nip_pretrained:
            self.nip.load_model(nip_pretrained)

        self._strengths = dict(manips.DEFAULT_STRENGTHS)
        requested = []
        for m in manipulations or list(DEFAULT_MANIPULATIONS):
            name, *strength = m.split(':')
            if name not in self._strengths:
                raise ValueError(f'Unsupported manipulation {name}! '
                                 f'Available: {sorted(self._strengths)}')
            if name not in requested:
                requested.append(name)
            if strength:
                self._strengths[name] = float(strength[-1])
        self._operations = [name for name in CANONICAL_ORDER if name in requested]
        self._forensics_classes = ['native'] + [
            f'{name}:{self._strengths[name]:g}' for name in self._operations]
        self._strength_candidates = {
            name: np.linspace(*manips.STRENGTH_RANGES[name], N_STRENGTH_CANDIDATES)
            for name in self._operations}
        if 'median' in self._strength_candidates:
            # the reference's candidates: odd sizes of the range, a drawn
            # index 0..7 clipped to them (so 9 takes 5 draws in 8)
            self._strength_candidates['median'] = sorted(
                {int(c) | 1 for c in self._strength_candidates['median']})
        # the strength ranges, copied to the device once for the steps' draws
        self._strength_lo, self._strength_hi = (
            torch.tensor([manips.STRENGTH_RANGES[m][k] for m in self._operations],
                         dtype=torch.float32, device=self.device) for k in (0, 1))

        self.fan = forensics.FAN(n_classes=self.n_classes,
                                 patch_size=2 * raw_patch_size // self.downsampling_factor,
                                 device=self.device, **(fan_args or {}))

        # A step checks its gradients for NaNs and waits for that check; with
        # nan_check False it keeps the flag on the device for assert_finite.
        self.nan_check = True
        self._rng_seed = rng_seed
        self._snapshot()
        self.reinitialize()

    @classmethod
    def restore(cls, run_dir, raw_patch_size=128, trainable=None, rng_seed=0,
                channel_dtype=None, channel_jpeg_dtype=None, manip_jpeg_dtype=None,
                remat=False, manipulations=None, distribution=None, device='cuda'):
        """Rebuild the flow of a finished run directory (``training.json`` +
        ``models/{fan,<nip>}/*.npz``) with its weights, as the reference's
        ``test_fan.py`` rebuilds it: the channel precision its log records
        (a key it lacks means float32), each overridden by a dtype argument
        given here; the FAN's dtype and stem from its logged arguments; the
        logged manipulations and distribution unless ``manipulations`` /
        ``distribution`` replace them. A learned codec is restored from the
        directory or preset its distribution names, as there: a snapshot of a
        trained codec under ``models/`` is not read."""
        with open(os.path.join(run_dir, 'training.json')) as f:
            log = json.load(f)
        precision = log.get('channel_precision') or {}
        fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
        if manipulations is None:
            manipulations = [m for m in log['manipulations'] if m != 'native']
        flow = cls(log['nip']['model'], manipulations=manipulations,
                   distribution=log['distribution'] if distribution is None else distribution,
                   fan_args=fan_args, trainable=trainable,
                   raw_patch_size=raw_patch_size, rng_seed=rng_seed,
                   nip_args=log['nip'].get('args'),
                   channel_dtype=channel_dtype or precision.get('channel_dtype', 'float32'),
                   channel_jpeg_dtype=(channel_jpeg_dtype
                                       or precision.get('channel_jpeg_dtype', 'float32')),
                   manip_jpeg_dtype=(manip_jpeg_dtype
                                     or precision.get('manip_jpeg_dtype', 'float32')),
                   remat=remat, device=device)
        models_dir = os.path.join(run_dir, 'models')
        flow.fan.load_model(os.path.join(models_dir, 'fan'))
        nip_dir = os.path.join(models_dir, flow.nip.scoped_name)
        if os.path.isdir(nip_dir) and flow.nip.count_parameters() > 0:
            flow.nip.load_model(nip_dir)
        flow._snapshot()
        return flow

    @property
    def channel_precision(self):
        """The compute dtypes as ``training.json`` records them."""
        return {'channel_dtype': 'bfloat16' if self._channel_dtype == torch.bfloat16 else 'float32',
                'channel_jpeg_dtype': 'bfloat16' if self._channel_jpeg_bf16 else 'float32',
                'manip_jpeg_dtype': 'bfloat16' if self._manip_jpeg_bf16 else 'float32'}

    def _snapshot(self):
        """Keep a copy of every parameter for :meth:`reinitialize`."""
        self._initial_params = {name: {k: p.detach().clone() for k, p in part.items()}
                                for name, part in self._collect_params().items()}

    def reinitialize(self):
        """Reset to the state after construction (after ``restore``, the
        restored weights): parameters, the Adam state, the random generators,
        the deferred NaN flags and the models' metric histories."""
        with torch.no_grad():
            for name, part in self._collect_params().items():
                for k, p in part.items():
                    p.copy_(self._initial_params[name][k])
        self._train_params = [p for part in self._train_partition(self._collect_params()).values()
                              for p in part.values()]
        self.optimizer = torch.optim.Adam(self._train_params, lr=1e-4, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=0)
        self._rng = np.random.default_rng(self._rng_seed)
        self._generator = torch.Generator(device=self.device).manual_seed(self._rng_seed)
        self._finite_flags = []
        self._scan_step = 0
        for model in (self.fan, self.nip, self.codec):
            if model is not None:
                model.reset_performance_stats()

    # -- properties and partitions ---------------------------------------------------

    @property
    def n_classes(self):
        return len(self._operations) + 1

    @property
    def downsampling_factor(self):
        ds = self._distribution['downsampling']
        if ds == 'none':
            return 1
        return int(ds.split(':')[-1]) if ':' in ds else 2

    def _codec_is_trainable(self):
        return isinstance(self.codec, DCN) or (self.codec is not None and self.codec.trainable)

    def _collect_params(self):
        """{'fan': {name: parameter}, 'nip': {...}} and under 'dcn' the
        learned codec's parameters or a trainable JPEG channel's q-tables."""
        params = {'fan': dict(self.fan.module.named_parameters()),
                  'nip': dict(self.nip.module.named_parameters())}
        if isinstance(self.codec, DCN):
            params['dcn'] = dict(self.codec.module.named_parameters())
        elif self._codec_is_trainable():
            params['dcn'] = dict(self.codec._model.params)
        return params

    def _train_partition(self, params):
        return {k: v for k, v in params.items() if k in self._trainable}

    def _frozen_partition(self, params):
        return {k: v for k, v in params.items() if k not in self._trainable}

    # -- the path on NCHW tensors -------------------------------------------------------

    def _manip_jpeg(self, batch, quality):
        """The 'jpeg' manipulation in bfloat16 (``manip_jpeg_dtype``): the
        plane form at 'default' precision, at a fixed quality or one held in
        a 0-d tensor."""
        if isinstance(quality, (int, float)):
            q_luma, q_chroma = jpeg_models.qtables(int(quality), batch.device)
        else:
            q = quality.to(torch.float32)
            q_luma, q_chroma = (jpeg_models.jpeg_qtable_traced(q, c) for c in (0, 1))
        return jpeg_models.jpeg_forward_nchw(batch.to(torch.bfloat16), q_luma, q_chroma,
                                             precision='default')[0]

    def _manipulate(self, batch_Y, strength_scalars=None, strength_indices=None, noise=None,
                    pool=False):
        """(K+1)-way batch expansion in the channel dtype: [native] + each
        manipulation, class-major. ``strength_scalars`` (K,) and
        ``strength_indices`` (K,), tensors on the device, randomize the
        strengths: manipulation i takes scalar i, or (resample, median)
        candidate ``strength_indices[i]`` of its range. ``noise``: awgn's
        standard normal noise (batch_Y's shape), drawn from the flow's
        generator when None.

        ``pool`` fuses the channel's 2x average pooling into each branch, as
        the reference's ``pool=True`` does: gaussian and resample at a fixed
        strength take their exact folded kernels (``POOLED_MANIPULATIONS``),
        every other branch is pooled in its own dtype before the cast, and
        the concatenation joins quarter-size tensors. Off in ``_forward``, as
        in the reference; no entry point sets it (only the tests and
        ``chip_smoke.py``'s comparison with the two-op form do)."""
        batch_Y = batch_Y.to(self._channel_dtype)
        if noise is None:
            noise = self._awgn_noise(batch_Y.shape, batch_Y.dtype)
        p2 = (lambda t: ops.avg_pool(t, 2)) if pool else (lambda t: t)
        y_list = [p2(batch_Y)]
        for i, name in enumerate(self._operations):
            strength = self._strengths[name] if strength_scalars is None else strength_scalars[i]
            if name == 'jpeg' and self._manip_jpeg_bf16:
                y = p2(self._manip_jpeg(batch_Y, strength))
            elif strength_scalars is None and pool and name in manips.POOLED_MANIPULATIONS:
                y = manips.POOLED_MANIPULATIONS[name](batch_Y, strength)
            elif strength_scalars is None:
                y = p2(manips.MANIPULATIONS[name](batch_Y, strength, noise))
            elif name in manips.TRACED_MANIPULATIONS:
                y = p2(manips.TRACED_MANIPULATIONS[name](batch_Y, strength, noise))
            elif name == 'resample':
                y = p2(manips.resample_switch(batch_Y, strength_indices[i],
                                              self._strength_candidates[name]))
            else:
                y = p2(manips.median_switch(batch_Y, strength_indices[i],
                                            self._strength_candidates[name]))
            y_list.append(y.to(self._channel_dtype))
        return torch.cat(y_list, dim=0)

    def _awgn_noise(self, shape, dtype):
        """awgn's standard normal noise for the expansion of an RGB batch of
        ``shape`` (NCHW), drawn on the device from the flow's generator in
        float32 and rounded to ``dtype`` once (the reference draws it in that
        dtype); None without an awgn branch."""
        if 'awgn' not in self._operations:
            return None
        mesh = mesh_lib.active()
        if mesh is None:
            return torch.randn(shape, generator=self._generator, device=self.device).to(dtype)
        # a data-parallel step: drawn for the global batch, this rank's rows kept
        noise = torch.randn((shape[0] * mesh.world_size, *shape[1:]), generator=self._generator,
                            device=self.device)
        return mesh_lib.local_rows(noise, shape[0], mesh).to(dtype)

    def _downsample(self, batch):
        ds = self._distribution['downsampling']
        factor = self.downsampling_factor
        if ds.startswith('pool'):
            pool = ops.avg_pool_flat if self._pool_impl == 'flat' else ops.avg_pool
            return pool(batch, factor)
        if ds == 'bilinear':
            return manips.resize_bilinear(batch, batch.shape[-2] // factor,
                                          batch.shape[-1] // factor)
        return batch

    @profiling.spanned('channel')
    def _compress(self, batch, q_luma, q_chroma):
        """The channel: (its output in the channel dtype, the entropy of the
        learned codec's latent, else None). The learned codec runs in float32.
        The JPEG runs through its own (trainable) q-tables in float32 when it
        has them, else through ``q_luma``, ``q_chroma`` in float32 (K1) or,
        with ``channel_jpeg_dtype`` 'bfloat16', in bfloat16 through the plane
        form; without a codec the batch passes as it is."""
        if isinstance(self.codec, DCN):
            y, entropy = self.codec._apply(batch.to(torch.float32))
            return y.to(self._channel_dtype), entropy
        if self.codec is None:
            return batch, None
        precision = None
        if self.codec.trainable:
            tables = self.codec._model.params
            q_luma, q_chroma = tables['q_mtx_luma'], tables['q_mtx_chroma']
            batch = batch.to(torch.float32)
        elif self._channel_jpeg_bf16:
            batch, precision = batch.to(torch.bfloat16), 'default'
        else:
            batch = batch.to(torch.float32)
        # the reference never calls libjpeg inside the flow: its channel rounds 'soft' there
        rounding = 'soft' if self.codec.codec == 'libjpeg' else self.codec.codec
        y, _ = jpeg_models.jpeg_forward_nchw(batch, q_luma, q_chroma, rounding=rounding,
                                             precision=precision)
        return y.to(self._channel_dtype), None

    def _forward(self, batch_x, q_luma, q_chroma, strength_scalars=None, strength_indices=None,
                 noise=None):
        if noise is None:
            scale = 1 if self.nip.in_channels == 3 else 2          # ONet passes RGB through
            noise = self._awgn_noise((batch_x.shape[0], 3, scale * batch_x.shape[-2],
                                      scale * batch_x.shape[-1]), self._channel_dtype)

        def acquire(x):
            with profiling.span('isp'):
                batch_Y = self.nip.module(x)
            with profiling.span('manipulations'):
                return batch_Y, self._downsample(self._manipulate(batch_Y, strength_scalars,
                                                                  strength_indices, noise))

        if self.remat and torch.is_grad_enabled():
            batch_Y, batch_c = checkpoint(acquire, batch_x, use_reentrant=False)
        else:
            batch_Y, batch_c = acquire(batch_x)
        batch_C, entropy = self._compress(batch_c, q_luma, q_chroma)
        with profiling.span('fan'):
            probs = self.fan.module(batch_C)
        return batch_Y, batch_c, batch_C, entropy, probs

    def _batch_labels(self, batch_size):
        """Class-major labels of an expanded batch, on the device."""
        return torch.arange(self.n_classes, device=self.device).repeat_interleave(batch_size)

    def _losses(self, batch_x, batch_y, q_luma, q_chroma, lambda_nip, lambda_dcn,
                strength_scalars=None, strength_indices=None, noise=None, world=1):
        """(loss, {'ce', 'nip', 'dcn'}) of NHWC float batches: RAW ``batch_x``
        and the target RGB ``batch_y`` (or None), and awgn's NHWC ``noise``
        (or None). The loss is the cross-entropy plus λ_nip times the NIP's
        loss if the NIP trains and λ_dcn times the channel's if it trains.

        With ``world`` > 1 the batches are this rank's rows of a data-parallel
        step's global batch and each term is the rank's share of the global
        one, so that the shares sum to it over the ranks: a batch mean over
        ``world``, a learned codec's L2 sum as it is and its entropy term
        (the global latent's) over ``world``."""
        batch_Y, batch_c, batch_C, entropy, probs = self._forward(
            batch_x.permute(0, 3, 1, 2), q_luma, q_chroma, strength_scalars, strength_indices,
            None if noise is None else noise.permute(0, 3, 1, 2))
        with profiling.span('loss'):
            loss_ce = forensics.sparse_categorical_crossentropy(
                self._batch_labels(batch_x.shape[0]), probs)
            zero = torch.zeros((), device=probs.device)
            loss_nip = (self.nip.loss(batch_y, batch_Y.permute(0, 2, 3, 1))
                        if batch_y is not None else zero)
            if isinstance(self.codec, DCN):
                loss_dcn = self.codec.loss(batch_c.to(torch.float32), batch_C.to(torch.float32),
                                           entropy if world == 1 else entropy / world)
            elif self.codec is not None:
                loss_dcn = self.codec.loss(batch_c.to(torch.float32), batch_C.to(torch.float32),
                                           entropy)
            else:
                loss_dcn = zero
            if world > 1:
                loss_ce, loss_nip = loss_ce / world, loss_nip / world
                if not isinstance(self.codec, DCN):
                    loss_dcn = loss_dcn / world
            loss = loss_ce
            if 'nip' in self._trainable:
                loss = loss + lambda_nip * loss_nip
            if 'dcn' in self._trainable:
                loss = loss + lambda_dcn * loss_dcn
            return loss, {'ce': loss_ce, 'nip': loss_nip, 'dcn': loss_dcn}

    # -- random draws -----------------------------------------------------------------

    def _has_jpeg(self):
        return self.codec is not None and not isinstance(self.codec, DCN)

    def _channel_qtables(self):
        """The channel's (luma, chroma) tables for a forward, a randomized
        quality drawn on the host by the codec; (None, None) without a JPEG."""
        if not self._has_jpeg():
            return None, None
        quality = self.codec._resolve_quality(None) if self.codec.quality is not None else 50
        return jpeg_models.qtables(quality, self.device)

    def _channel_qtables_in_graph(self):
        """The channel's tables for a training step, drawn on the device: a
        fixed quality's tables, a quality drawn from [lo, hi) of a 2-range, or
        one of a longer set's tables; (None, None) without a JPEG."""
        if not self._has_jpeg():
            return None, None
        quality = self.codec.quality if self.codec.quality is not None else 50
        if jpeg_models._is_number(quality):
            return jpeg_models.qtables(int(quality), self.device)
        if len(quality) == 2:
            q = torch.randint(int(quality[0]), int(quality[1]), (), generator=self._generator,
                              device=self.device).to(torch.float32)
            return jpeg_models.jpeg_qtable_traced(q, 0), jpeg_models.jpeg_qtable_traced(q, 1)
        tables = [jpeg_models.qtables(int(q), self.device) for q in quality]
        idx = torch.randint(0, len(quality), (1,), generator=self._generator, device=self.device)
        return tuple(torch.index_select(torch.stack(t), 0, idx)[0] for t in zip(*tables))

    def _sample_strengths(self):
        """Randomized strengths drawn on the host from ``rng_seed``'s numpy
        generator, as the reference draws them for a forward: (scalars,
        indices) on the device."""
        scalars = np.zeros(len(self._operations), dtype=np.float32)
        indices = np.zeros(len(self._operations), dtype=np.int64)
        for i, name in enumerate(self._operations):
            lo, hi = manips.STRENGTH_RANGES[name]
            scalars[i] = self._rng.uniform(lo, hi)
            indices[i] = self._rng.integers(0, N_STRENGTH_CANDIDATES)
        return (profiling.to_device(scalars, self.device),
                profiling.to_device(indices, self.device))

    def _sample_strengths_in_graph(self):
        """Randomized strengths of a training step, drawn on the device."""
        n = len(self._operations)
        lo, hi = self._strength_lo, self._strength_hi
        scalars = lo + (hi - lo) * torch.rand(n, generator=self._generator, device=self.device)
        indices = torch.randint(0, N_STRENGTH_CANDIDATES, (n,), generator=self._generator,
                                device=self.device)
        return scalars, indices

    # -- training -----------------------------------------------------------------------

    def _batch(self, batch):
        """An NHWC batch (numpy or tensor; uint8 / uint16 / float) as float32
        in [0, 1] on the flow's device."""
        with profiling.span('input'):
            return ops.normalize_batch(profiling.to_device(batch, self.device))

    def loss_and_gradients(self, batch_x, batch_y, lambda_nip=0, lambda_dcn=0,
                           q_tables=None, strength_scalars=None, strength_indices=None,
                           noise=None):
        """The loss, its parts and the gradient of every trainable parameter,
        without an update: (loss, {'ce', 'nip', 'dcn'}, {part: {name:
        gradient}}). ``q_tables`` (luma, chroma) default to the channel's
        fixed quality; the strengths to the fixed ones; awgn's noise (NHWC,
        the developed RGB batch's shape) to a draw from the flow's
        generator.

        Under ``parallel`` the batches (and ``noise``) are this rank's rows of
        the global batch and the results are the global step's: the rank
        differentiates its share of the global loss (``_losses``), and one
        all-reduce sums the shares' gradients and values over the ranks."""
        x = self._batch(batch_x)
        y = None if batch_y is None else self._batch(batch_y)
        if noise is not None:
            noise = profiling.to_device(noise, self.device)
        mesh = self.parallel.mesh if self.parallel is not None else None
        world = 1 if self.parallel is None else self.parallel.n_devices
        with mesh_lib.batch_reductions(mesh):
            q_luma, q_chroma = q_tables if q_tables is not None else self._channel_qtables()
            loss, parts = self._losses(x, y, q_luma, q_chroma, lambda_nip, lambda_dcn,
                                       strength_scalars, strength_indices, noise, world)
            with profiling.span('backward'):
                grads = torch.autograd.grad(loss, self._train_params, allow_unused=True)
        names = [(part, k) for part, ps in self._train_partition(self._collect_params()).items()
                 for k in ps]
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._train_params, grads)]
        if self.parallel is not None:
            keys = sorted(parts)
            grads, values = self.parallel.reduce(
                grads, [loss.detach()] + [parts[k].detach() for k in keys])
            loss, parts = values[0], dict(zip(keys, values[1:]))
        by_part = {}
        for (part, k), g in zip(names, grads):
            by_part.setdefault(part, {})[k] = g
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, by_part

    @profiling.spanned('step')
    def _step(self, batch_x, batch_y, lambda_nip, lambda_dcn, augment, learning_rate):
        """One joint step; returns (loss, parts, finite), ``finite`` a 0-d bool
        tensor on the device saying whether every gradient was finite (under
        ``parallel``, of the summed gradients: a non-finite gradient of any
        rank makes the sum non-finite on every rank, so all ranks raise
        together). The draws are the global batch's: the channel's quality and
        the strengths are one draw for all rows, awgn's noise is drawn for the
        global batch (``_awgn_noise``)."""
        q_tables = self._channel_qtables_in_graph()
        scalars, indices = self._sample_strengths_in_graph() if augment else (None, None)
        loss, parts, grads = self.loss_and_gradients(batch_x, batch_y, lambda_nip, lambda_dcn,
                                                     q_tables, scalars, indices)
        with profiling.span('optimizer'):
            flat = [g for part in grads.values() for g in part.values()]
            finite = torch.stack([torch.isfinite(g).all() for g in flat]).all()
            for p, g in zip(self._train_params, flat):
                p.grad = g
            for group in self.optimizer.param_groups:
                group['lr'] = float(learning_rate)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        return loss, parts, finite

    def training_step(self, batch_x, batch_y, lambda_nip=0, lambda_dcn=0,
                      augment=False, learning_rate=1e-4):
        """One joint step: the loss of an NHWC RAW batch and its target RGB
        (or None), its gradient over the trainable partition and one Adam
        step (optax's ``scale_by_adam`` then −lr·u) at ``learning_rate``.
        ``augment`` draws the manipulation strengths on the device; a
        randomized channel quality is drawn there in any case. Returns (loss,
        {'ce', 'nip', 'dcn'}) as 0-d tensors on the device. Raises
        RuntimeError on a non-finite gradient (with ``nan_check``; the update
        has been applied then, and ``reinitialize`` restores the flow)."""
        loss, parts, finite = self._step(batch_x, batch_y, lambda_nip, lambda_dcn, augment,
                                         learning_rate)
        if self.nan_check:
            if not bool(finite):
                raise RuntimeError('∇ NaNs encountered in the joint training step')
        else:
            self._finite_flags.append(finite)
        return loss, parts

    def training_scan(self, sampler, n_steps, lambda_nip=0, lambda_dcn=0, augment=False,
                      learning_rate=1e-4):
        """``n_steps`` training steps on batches that ``sampler`` (a
        ``DeviceSampler`` on the flow's device) draws on the device, numbered
        on from the flow's last scanned step (0 after ``reinitialize``).
        Returns (losses, nip_losses), tensors of length ``n_steps`` on the
        device; the finite flags wait for ``assert_finite``."""
        losses, nip_losses = [], []
        for _ in range(n_steps):
            batch = sampler(self._scan_step)
            self._scan_step += 1
            batch_x, batch_y = {'xy': batch, 'y': (batch, batch),
                                'x': (batch, None)}[sampler._loaded]
            loss, parts, finite = self._step(batch_x, batch_y, lambda_nip, lambda_dcn, augment,
                                             learning_rate)
            losses.append(loss)
            nip_losses.append(parts['nip'])
            self._finite_flags.append(finite)
        return torch.stack(losses), torch.stack(nip_losses)

    def assert_finite(self, timeout_s=None):
        """The deferred NaN check of the steps run with ``nan_check`` False:
        one device→host copy for all of them.

        ``timeout_s`` bounds that copy (``runtime.fetch_with_timeout``): past
        it the check is skipped with a warning instead of blocking on a
        stalled device."""
        if not self._finite_flags:
            return
        flags = torch.stack(self._finite_flags).all()
        self._finite_flags = []
        if timeout_s is not None:
            flags = runtime.fetch_with_timeout(flags, timeout_s)
            if flags is None:
                warnings.warn('assert_finite: device→host transfer timed out; '
                              'NaN check skipped (downlink stalled)')
                return
        if not bool(flags):
            raise RuntimeError('∇ NaNs encountered in a joint training step')

    # -- public API -------------------------------------------------------------------

    def run_workflow(self, batch_x, augment=False):
        """NHWC RAW batch (N, h, w, 4) in [0,1] (RGB (N, h, w, 3) for ONet) →
        (batch_Y, batch_c, batch_C, entropy, probabilities): the developed
        RGB, the downsampled expanded batch and its channel output (NHWC
        views), the learned codec's latent entropy (0 for a JPEG), and the
        class probabilities ((K+1)·N, K+1), rows class-major. ``augment``
        draws the strengths (and a randomized channel quality) on the host."""
        with profiling.root('request'):
            with profiling.span('input'):
                x = profiling.to_device(batch_x, self.device, torch.float32)
            q_luma, q_chroma = self._channel_qtables()
            scalars, indices = self._sample_strengths() if augment else (None, None)
            with torch.no_grad():
                batch_Y, batch_c, batch_C, entropy, probs = self._forward(
                    x.permute(0, 3, 1, 2), q_luma, q_chroma, scalars, indices)
            nhwc = [t.permute(0, 2, 3, 1) for t in (batch_Y, batch_c, batch_C)]
            return (*nhwc, self._entropy_or_zero(entropy), probs)

    def run_workflow_to_decisions(self, batch_x, augment=False):
        """Predicted class of every row of :meth:`run_workflow`, as a numpy array."""
        with profiling.span('request'):
            probs = self.run_workflow(batch_x, augment=augment)[-1]
            with profiling.span('readback'):
                return probs.argmax(dim=1).cpu().numpy()

    def run_manipulations(self, batch_y, randomize=False, override=None):
        """The expanded NHWC batch of an NHWC RGB batch: at the fixed
        strengths, at host-drawn ones (``randomize``) or at ``override``
        {name: strength} (float32, as the reference's); awgn's noise drawn
        from the flow's generator."""
        y = self._batch(batch_y).permute(0, 3, 1, 2)
        with torch.no_grad():
            if randomize:
                out = self._manipulate(y, *self._sample_strengths())
            elif override is not None:
                noise = self._awgn_noise(y.shape, y.dtype)
                out = torch.cat([y] + [manips.MANIPULATIONS[name](y, override[name], noise)
                                       for name in self._operations], dim=0)
            else:
                out = self._manipulate(y)
        return out.permute(0, 2, 3, 1)

    def run_downsampling(self, batch_y):
        with torch.no_grad():
            return self._downsample(self._batch(batch_y).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def run_compression(self, batch_y, return_entropy=False):
        with torch.no_grad():
            out, entropy = self._compress(self._batch(batch_y).permute(0, 3, 1, 2),
                                          *self._channel_qtables())
        out = out.permute(0, 2, 3, 1)
        return (out, self._entropy_or_zero(entropy)) if return_entropy else out

    def _entropy_or_zero(self, entropy):
        """A result's entropy: the learned codec's, else 0."""
        return torch.zeros((), device=self.device) if entropy is None else entropy

    def _rgb_to_fan(self, batch_Y):
        return self.run_compression(self.run_downsampling(self.run_manipulations(batch_Y)))

    def run_rgb_to_fan(self, batch_Y):
        """The FAN's input for an NHWC RGB batch, as float32 numpy NHWC (a
        bfloat16 channel's values exactly)."""
        return self._rgb_to_fan(batch_Y).to(torch.float32).cpu().numpy()

    def run_rgb_to_probabilities(self, batch_Y):
        """Class probabilities (numpy) for an NHWC RGB batch; the FAN takes
        its input in the channel dtype."""
        return self.fan.process(self._rgb_to_fan(batch_Y)).cpu().numpy()

    # -- summaries ----------------------------------------------------------------------

    def is_trainable(self, model):
        return model in self._trainable

    @property
    def trainable_models(self):
        return tuple(self._trainable)

    def _summary_parts(self):
        ds = self._distribution['downsampling']
        return {'cls': type(self).__name__, 'nip': self.nip.class_name,
                'mn': ''.join(x[0] for x in self._forensics_classes),
                'tr': ''.join(x[0] for x in self.trainable_models),
                'pool': '' if ds == 'none' else f'-> {ds} ',
                'codec': '' if self.codec is None else f'-> {self.codec.summary_compact()} '}

    def summary_compact(self):
        return '{cls}[{tr}]: {nip} -> [{mn}] {pool}{codec}-> FAN'.format(**self._summary_parts())

    def summary(self):
        return ('{cls}[opt={tr}]: {inp} -> {nip} -> {n} manipulations [{mn}] '
                '{pool}{codec}-> FAN -> (prob. {k} classes)').format(
            inp='(rgb)' if self.nip.in_channels == 3 else '(raw)', n=self.n_classes - 1,
            k=self.n_classes, **self._summary_parts())

    def details(self):
        inp = '(rgb)' if self.nip.in_channels == 3 else '(raw)'
        return '\n'.join([
            self.summary(),
            f'Input         : raw patch {self.raw_patch_size} {inp}',
            f'Camera ISP    : {self.nip.summary()}',
            f'Manipulations : {self.n_classes} -> {self._forensics_classes}',
            f"Downsampling  : {self._distribution['downsampling']}",
            f"Codec         : {'' if self.codec is None else self.codec.summary()}",
            f'Forensics     : {self.fan.summary()}'])
