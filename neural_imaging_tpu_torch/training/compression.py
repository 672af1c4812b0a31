"""
The DCN (learned codec) trainer: port of ``neural_imaging_tpu/training/compression.py``.

Epochs of Adam steps over RGB patches, host-fed with the reference's resize
(a patch of [patch, 2·patch) shrunk by ``utils/image.resize_area``, OpenCV's
INTER_AREA), flip and gamma augmentations drawn from the caller's numpy
generator in its order (so both packages draw the same batches), or, with
``device_data=True`` (no resize, as in the reference),
``DCN.training_scan`` over a ``DeviceSampler`` with the same augmentations
drawn on the device. The learning rate halves every
``learning_rate_reduction_schedule`` epochs (re-applied on resume). Every
``validation_schedule`` epochs the validation set goes through ``compress``
→ ``decompress``: its L2 norm, SSIM and empirical entropy, a thumbnail
sheet of inputs and decodes (PNG), ``progress.json`` with the
{training_spec, data, codec} schema that the JAX package's R/D layer reads,
the npz snapshot and the Adam state (``adam.pt``) for ``resume``. Training
stops early when the validation SSIM converges or deteriorates. Per-epoch
scalars go to ``scalars.jsonl``.

Losses stay on the device between validation points, where one copy brings
them to the host. Not ported: ``visualize_distribution`` (matplotlib).

``parallel`` (a ``DataParallel``) trains over its ranks: every rank draws
the global batch with its augmentations from one generator (the caller's
``rng`` must be the same on every rank; without one the ranks agree on a
seed) and keeps its rows, the entropy is the global latent's, and the
summed gradients keep the ranks identical. Every rank validates the same
data and takes rank 0's metrics; only the primary writes files.
"""
import os
from collections import deque

import numpy as np
import torch

from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.data.png import write_png
from neural_imaging_tpu_torch.models.compression import AUGMENTATION_PROBS, GAMMA_RANGE
from neural_imaging_tpu_torch.parallel import multihost
from neural_imaging_tpu_torch.utils import jsonlog, metrics, stats
from neural_imaging_tpu_torch.utils.image import resize_area
from neural_imaging_tpu_torch.utils.profiling import ScalarLog
from neural_imaging_tpu_torch.utils.utils import logger

# the Adam state a validation point writes beside the npz, for resume
OPTIMIZER_FILE = 'adam.pt'
N_TAIL = 5


def default_training_spec():
    return {
        'n_epochs': 500,
        'batch_size': 20,
        'patch_size': 64,
        'learning_rate': 1e-4,
        'learning_rate_reduction_schedule': 1000,
        'learning_rate_reduction_factor': 0.5,
        'validation_schedule': 50,
        'convergence_threshold': 1e-4,
        'augmentation_probs': dict(AUGMENTATION_PROBS),
        'sample_dropout': False,
    }


def save_progress(dcn, data, training, out_dir):
    """Write ``progress.json``: {training_spec, data, codec: {model, init,
    args, codebook, performance}}."""
    jsonlog.save_json({
        'training_spec': training,
        'data': data.summary(),
        'codec': {
            'model': dcn.class_name,
            'init': repr(dcn),
            'args': dcn.get_hyperparameters(),
            'codebook': dcn.get_codebook().tolist(),
            'performance': dcn.performance,
        },
    }, os.path.join(out_dir, 'progress.json'))


def _batch_gamma(batch, rng):
    """x**(1/γ) with γ ~ U(GAMMA_RANGE) per image, drawn from ``rng`` as the
    reference's ``utils/image.py::batch_gamma`` draws it."""
    gamma = rng.uniform(*GAMMA_RANGE, size=(len(batch), 1, 1, 1)).astype(np.float32)
    return np.power(batch, 1.0 / gamma).clip(0, 1)


def _thumbnails(batch, ncols):
    """Tile an NHWC batch row by row into one image, as the reference's
    ``utils/plots.py::thumbnails`` does."""
    n, h, w, c = batch.shape
    nrows = -(-n // ncols)
    canvas = np.zeros((nrows * h, ncols * w, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, ncols)
        canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = np.clip(batch[i], 0, 1)
    return canvas


def _host_batch(data, batch_id, training, rng):
    """A training batch (float32 NHWC) augmented on the host, drawing from
    ``rng`` in the reference's order: resize, flip h, flip v, gamma."""
    probs = training['augmentation_probs']
    patch = training['patch_size']
    current_patch = int(rng.integers(patch, 2 * patch)) if rng.uniform() < probs['resize'] else patch
    batch_x = data.next_training_batch(batch_id, training['batch_size'], current_patch)
    if isinstance(batch_x, tuple):
        batch_x = batch_x[-1]
    if current_patch != patch:
        batch_x = resize_area(batch_x, patch)
    if rng.uniform() < probs['flip_h']:
        batch_x = batch_x[:, :, ::-1, :]
    if rng.uniform() < probs['flip_v']:
        batch_x = batch_x[:, ::-1, :, :]
    if rng.uniform() < probs['gamma']:
        batch_x = _batch_gamma(batch_x, rng)
    return np.ascontiguousarray(batch_x)


def _validate(dcn, data, training, v_batches, caches, out_dir, epoch, write=True):
    """Compress → decompress the validation set; append its mean L2 norm,
    SSIM and entropy to the history and write the thumbnail sheet (with
    ``write``)."""
    codebook = dcn.get_codebook()
    for batch_id in range(v_batches):
        batch_x = data.next_validation_batch(batch_id, training['batch_size'])
        if isinstance(batch_x, tuple):
            batch_x = batch_x[-1]
        batch_z = dcn.compress(batch_x)
        batch_y = dcn.decompress(batch_z).cpu().numpy()
        batch_z = batch_z.cpu().numpy()
        caches['loss'].append(float(np.linalg.norm(batch_x - batch_y)))
        caches['ssim'].append(metrics.batch(batch_x, batch_y, metrics.ssim))
        caches['entropy'].append(stats.entropy(batch_z, codebook))
    for key in ('loss', 'ssim', 'entropy'):
        dcn.performance[key]['validation'].append(float(np.mean(caches[key])))

    if not write:
        return
    # input/output pairs of the last batch, highest variance first
    indices = np.argsort(np.var(batch_x, axis=(1, 2, 3)))[::-1]
    pairs = np.concatenate((batch_x[indices[::2]], batch_y[indices[::2]]), axis=0)
    thumbs = _thumbnails(pairs, max(training['batch_size'] // 2, 1))
    write_png(os.path.join(out_dir, f'thumbnails-{epoch:05d}.png'),
              (255 * thumbs).astype(np.uint8))


def train_dcn(dcn, training, data, directory='./data/models/dcn/playground/',
              overwrite=False, rng=None, parallel=None,
              device_data=False, resume=False):
    """Train ``dcn`` on ``data`` (an RGB ``Dataset``) into
    ``<directory>/<model_code>/<scoped name>``; returns that directory. An
    existing one is kept unless ``overwrite`` or ``resume``.

    ``training`` updates ``default_training_spec()``. ``rng``: the numpy
    generator of the host-fed augmentations. ``resume`` continues a run from
    its npz, ``adam.pt`` (fresh Adam moments without it, as a run the JAX
    package wrote), metric history and epoch counter. ``device_data``
    trains from the training set on the codec's device. ``parallel``: a
    ``DataParallel`` whose ranks share each global batch."""
    spec = default_training_spec()
    spec.update(training or {})
    training = spec
    if rng is None:
        # the ranks of a parallel run draw alike: rank 0's seed
        rng = np.random.default_rng(multihost.agree(
            int(np.random.SeedSequence().generate_state(1)[0])))
    primary = multihost.is_primary()
    if parallel is not None:
        parallel.check_batch(training['batch_size'])
    if device_data and training['augmentation_probs'].get('resize', 0) > 0:
        raise ValueError('the resize augmentation is host-only; disable it or drop '
                         '--device-data')

    out_dir = os.path.join(directory, dcn.model_code, dcn.scoped_name)
    start_epoch = 0
    exists = multihost.agree(os.path.isdir(out_dir))
    if exists and resume:
        progress_file = os.path.join(out_dir, 'progress.json')
        if not os.path.isfile(progress_file):
            raise FileNotFoundError(f'Cannot resume: {progress_file} not found')
        logger.info('Resuming training from: %s', progress_file)
        dcn.load_model(out_dir)
        optimizer_file = os.path.join(out_dir, OPTIMIZER_FILE)
        if os.path.isfile(optimizer_file):
            dcn.optimizer.load_state_dict(torch.load(optimizer_file, map_location=dcn.device))
            logger.info('Restored the Adam state from %s', optimizer_file)
        else:
            logger.info('No %s: resuming with a fresh Adam state', OPTIMIZER_FILE)
        previous = jsonlog.load_json(progress_file)
        dcn.performance = previous['codec']['performance']
        start_epoch = int(previous['training_spec'].get('current_epoch', 0))
    elif exists and not overwrite:
        logger.warning('Directory %s exists, skipping... (use overwrite=True)', out_dir)
        return out_dir

    if parallel is not None:
        parallel.distribute(dcn)
        logger.info('Training %s', parallel.describe())
    sampler = None
    if device_data:
        sampler = DeviceSampler(data, training['batch_size'], training['patch_size'],
                                discard='flat', device=dcn.device, parallel=parallel)
        logger.info('Training from device-resident data (%d images on %s)', sampler.n_images,
                    dcn.device)

    n_batches = data['training']['y'].shape[0] // training['batch_size']
    v_batches = data['validation']['y'].shape[0] // training['batch_size']
    perf = dcn.performance
    train_caches = {k: deque(maxlen=n_batches) for k in ('loss', 'ssim', 'entropy')}
    val_caches = {k: deque(maxlen=v_batches) for k in ('loss', 'ssim', 'entropy')}
    # the reductions fire at epochs sched, 2·sched, …: re-apply those before the resume epoch
    learning_rate = training['learning_rate']
    if start_epoch > 0:
        n_reductions = (start_epoch - 1) // training['learning_rate_reduction_schedule']
        learning_rate *= training['learning_rate_reduction_factor'] ** n_reductions

    if primary:
        os.makedirs(out_dir, exist_ok=True)
    logger.info('Output directory: %s', out_dir)
    scalars = ScalarLog(os.path.join(out_dir, 'scalars.jsonl')) if primary else None
    pending = []     # one {loss, ssim, entropy, scaling} (on the device), lr and epoch an epoch

    def flush_pending():
        if not pending:
            return
        host = torch.stack([torch.stack([p[k] for k in ('loss', 'ssim', 'entropy', 'scaling')])
                            for p in pending]).double().cpu().numpy()
        for p, (loss, ssim, entropy, scaling) in zip(pending, host):
            for key, value in (('loss', loss), ('ssim', ssim), ('entropy', entropy)):
                perf[key]['training'].append(float(value))
            if scalars is not None:
                scalars.log(p['epoch'], loss=loss, ssim=ssim, entropy=entropy, lr=p['lr'],
                            scaling=0.0 if np.isnan(scaling) else scaling)
        pending.clear()

    def save_state(epoch, quiet=True):
        if not primary:
            return
        save_progress(dcn, data, training, out_dir)
        dcn.save_model(out_dir, epoch, quiet=quiet)
        torch.save(dcn.optimizer.state_dict(), os.path.join(out_dir, OPTIMIZER_FILE))

    for epoch in range(start_epoch, training['n_epochs']):
        training['current_epoch'] = epoch
        if epoch > 0 and epoch % training['learning_rate_reduction_schedule'] == 0:
            learning_rate *= training['learning_rate_reduction_factor']

        if sampler is not None:
            means = {k: v.mean() for k, v in dcn.training_scan(
                sampler, n_batches, learning_rate, training['augmentation_probs']).items()}
        else:
            for batch_id in range(n_batches):
                batch = _host_batch(data, batch_id, training, rng)
                if parallel is not None:
                    (batch,) = parallel.shard(batch)
                values = dcn.training_step(batch, learning_rate)
                for key, value in values.items():
                    train_caches[key].append(value)
            means = {k: torch.stack(list(v)).mean() for k, v in train_caches.items()}
        scaling = (dcn.module.latent_scale.detach().clone() if dcn._h.scale_latent
                   else torch.full((), float('nan'), device=dcn.device))
        pending.append({**means, 'scaling': scaling, 'lr': learning_rate, 'epoch': epoch})

        if epoch % training['validation_schedule'] == 0:
            flush_pending()          # waits for the epochs queued before it
            logger.debug('epoch %d: validating', epoch)
            _validate(dcn, data, training, v_batches, val_caches, out_dir, epoch, primary)
            dcn.performance = perf = multihost.agree(dcn.performance)
            save_state(epoch)
            logger.info('epoch %d: loss %.4f, entropy %.3f, lr %.1e, validation ssim %.4f',
                        epoch, perf['loss']['training'][-1], perf['entropy']['training'][-1],
                        learning_rate, perf['ssim']['validation'][-1])

            v_ssim = perf['ssim']['validation']
            if len(v_ssim) > 5:
                current = np.mean(v_ssim[-N_TAIL:])
                previous = np.mean(v_ssim[-(N_TAIL + 1):-1])
                change = abs((current - previous) / previous)
                if change < training['convergence_threshold']:
                    logger.info('Early stopping - model converged, SSIM change %.4f', change)
                    break
                if current < 0.9 * previous:
                    logger.info('Error - SSIM deterioration by more than 10%% %.4f -> %.4f',
                                previous, current)
                    break

    flush_pending()
    if scalars is not None:
        scalars.close()
    save_state(training.get('current_epoch', 0), quiet=False)
    return out_dir
