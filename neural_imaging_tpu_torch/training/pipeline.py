"""
The NIP (camera ISP) trainer: port of ``neural_imaging_tpu/training/pipeline.py``.

An epoch of Adam steps over the training set (``NIPModel.training_step`` on
batches from the host through ``EpochPrefetcher``, or, with
``device_data=True``, ``NIPModel.training_scan`` over a ``DeviceSampler``
of the training set copied to the device once), validation every
``validation_schedule`` epochs (PSNR, SSIM and the loss on the host in
float64), ``progress.json`` (the reference's schema, which its results
tooling reads), snapshots in the JAX package's npz format (optionally only
the best), the learning rate's back-off by 0.95 when the validation loss
regresses by 20%, the early stop on convergence, and ``resume``.

Per-epoch losses stay on the device between validation points, where one
copy brings them to the host. Each validation point writes the Adam state
to ``adam.pt`` beside the npz, and a resumed run restores it from there; a
run the JAX package wrote has no such file and resumes with fresh moments,
as the reference does without orbax. Progress is one log line per
validation point, and a debug line where each validation starts, once the
epochs before it have run on the device. The reference's figures need
matplotlib and are not written.

``parallel`` (a ``DataParallel``) trains over its ranks, each taking its
rows of every global batch (the same draws on every rank) and the same
summed gradients, so the ranks stay identical. Every rank validates the
same data and takes rank 0's metrics, so their control flow (learning-rate
back-off, early stop) stays in lockstep; only the primary writes files.
"""
import os
from collections import OrderedDict

import numpy as np
import torch

from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.data.prefetch import EpochPrefetcher
from neural_imaging_tpu_torch.parallel import multihost
from neural_imaging_tpu_torch.utils import jsonlog, metrics
from neural_imaging_tpu_torch.utils.jsonlog import save_progress
from neural_imaging_tpu_torch.utils.utils import logger

# the Adam state a validation point writes beside the npz, for resume
OPTIMIZER_FILE = 'adam.pt'
N_TAIL = 5


def validate(model, data, loss_metric='L2'):
    """Develop the validation set; returns (ssims, psnrs, losses, developed),
    the metrics per image on the host in float64 (the losses on the 0-255
    scale) and the developed images as numpy. The reference's figure of
    them is not written."""
    if loss_metric not in ('L2', 'L1', 'SSIM', 'MS-SSIM'):
        raise ValueError(f'Unsupported loss ({loss_metric})!')
    example_x, example_y = data.next_validation_batch(0, data.count_validation)
    developed = model.process(example_x).clamp(0, 1).cpu().numpy()

    ssims, psnrs, losses = [], [], []
    for b in range(data.count_validation):
        reference, dev = example_y[b], developed[b]
        ssim = float(metrics.ssim(reference, dev))
        psnrs.append(float(metrics.psnr(reference, dev)))
        if loss_metric == 'L2':
            loss = metrics.mse(255 * reference, 255 * dev)
        elif loss_metric == 'L1':
            loss = metrics.mae(255 * reference, 255 * dev)
        else:
            loss = 255 * (1 - ssim)
        ssims.append(ssim)
        losses.append(float(loss))
    return ssims, psnrs, losses, developed


def _check_data(data, patch_size, batch_size):
    try:
        probe = min(5, data.count_training)
        bx, by = data.next_training_batch(0, probe, patch_size * 2)
        if bx.shape != (probe, patch_size, patch_size, 4) or \
                by.shape != (probe, 2 * patch_size, 2 * patch_size, 3):
            raise ValueError('The training batch returned by the dataset is of invalid size!')
    except Exception as e:
        raise ValueError(f'Data set error: {e}') from e
    if batch_size > data.count_training or batch_size > data.count_validation:
        raise ValueError(f'Batch size ({batch_size}) exceeds dataset size '
                         f'({data.count_training}/{data.count_validation})!')


def train_nip_model(model, camera_name, n_epochs=10000, lr_schedule=None,
                    validation_loss_threshold=1e-3, validation_schedule=100,
                    resume=False, patch_size=64, batch_size=20, data=None,
                    out_directory_root='./data/models/nip', save_best=False,
                    discard='flat', parallel=None, device_data=False):
    """Train ``model`` (a ``NIPModel``) on ``data`` (a ``Dataset`` of RAW and
    RGB) into ``<out_directory_root>/<camera>/<model_code>/<scoped name>``;
    returns that directory. An existing one is kept unless ``resume``.

    ``lr_schedule``: {epoch: learning rate} (or one rate); ``None`` is 1e-4.
    ``validation_loss_threshold``: the early stop's relative change of the
    validation loss (None never stops early). ``device_data``: train from
    the training set on the model's device. ``parallel``: a ``DataParallel``
    whose ranks share each global batch of ``batch_size``."""
    if parallel is not None:
        parallel.check_batch(batch_size)
    primary = multihost.is_primary()
    if data is None:
        raise ValueError('Training data seems not to be loaded!')
    if model.count_parameters() == 0:
        raise ValueError(f'{model.class_name} has no parameters to train')
    _check_data(data, patch_size, batch_size)

    out_directory = os.path.join(out_directory_root, camera_name, model.model_code,
                                 model.scoped_name)
    if multihost.agree(os.path.exists(out_directory)) and not resume:
        logger.warning('directory %s exists, skipping...', out_directory)
        return out_directory

    n_batches = data.count_training // batch_size
    start_epoch = 0
    if resume:
        summary_file = os.path.join(out_directory, 'progress.json')
        if not os.path.isfile(summary_file):
            raise FileNotFoundError(f'Could not open file {summary_file}')
        logger.info('Resuming training from: %s', summary_file)
        model.load_model(out_directory)
        optimizer_file = os.path.join(out_directory, OPTIMIZER_FILE)
        if os.path.isfile(optimizer_file):
            model.optimizer.load_state_dict(torch.load(optimizer_file,
                                                       map_location=model.device))
            logger.info('Restored the Adam state from %s', optimizer_file)
        else:
            logger.info('No %s: resuming with a fresh Adam state', OPTIMIZER_FILE)
        summary_data = jsonlog.load_json(summary_file)
        model.performance = summary_data['performance']
        start_epoch = summary_data['summary']['Epoch']

    if parallel is not None:
        parallel.distribute(model)

    if lr_schedule is None:
        lr_schedule = {0: 1e-4}
    elif isinstance(lr_schedule, float):
        lr_schedule = {0: lr_schedule}
    lr_schedule = {int(k): v for k, v in lr_schedule.items()}

    training_summary = OrderedDict()
    training_summary['Camera'] = camera_name
    training_summary['Architecture'] = model.summary()
    training_summary['Max epochs'] = n_epochs
    training_summary['Learning rate'] = {str(k): v for k, v in lr_schedule.items()}
    training_summary['Training data size'] = str(data['training'][data._loaded_data[0]].shape)
    training_summary['Validation data size'] = str(data['validation'][data._loaded_data[0]].shape)
    training_summary['# batches'] = n_batches
    training_summary['Patch size'] = patch_size
    training_summary['Batch size'] = batch_size
    training_summary['Validation schedule'] = validation_schedule
    training_summary['Start epoch'] = start_epoch
    training_summary['Saved checkpoint'] = None
    training_summary['Discarding policy'] = discard
    training_summary['Output directory'] = out_directory

    if primary:
        print('\n## Training summary')
        for k, v in training_summary.items():
            print(f'{k:30s}: {v}')
        print('', flush=True)
    if parallel is not None:
        logger.info('Training %s', parallel.describe())
    logger.info('Validation figures need matplotlib and are not written')

    # on resume, start from the schedule entry in effect at start_epoch
    past = [k for k in lr_schedule if k <= start_epoch]
    learning_rate = lr_schedule[max(past)] if past else 1e-4
    pending_losses = []          # per-epoch mean losses, on the device

    def flush_pending():
        if pending_losses:
            for v in torch.stack(pending_losses).double().cpu().numpy():
                model.log_metric('loss', 'training', float(v))
            pending_losses.clear()

    def save_checkpoint(epoch, quiet=True):
        training_summary['Saved checkpoint'] = epoch
        model.save_model(out_directory, epoch, quiet=quiet)
        if primary:
            torch.save(model.optimizer.state_dict(), os.path.join(out_directory,
                                                                  OPTIMIZER_FILE))

    if device_data:
        sampler = DeviceSampler(data, batch_size, 2 * patch_size, discard=discard,
                                device=model.device, parallel=parallel)
        logger.info('Training from device-resident data (%d images on %s)', sampler.n_images,
                    model.device)
    else:
        prefetcher = EpochPrefetcher(data, batch_size, 2 * patch_size, model.device, discard,
                                     parallel=parallel)

    epoch = start_epoch
    for epoch in range(start_epoch, n_epochs):
        if epoch in lr_schedule:
            learning_rate = lr_schedule[epoch]

        if device_data:
            losses = model.training_scan(sampler, sampler.epoch_steps(), learning_rate)
        else:
            losses = torch.stack([model.training_step(bx, by, learning_rate)
                                  for bx, by in prefetcher])
        pending_losses.append(losses.mean())

        if epoch % validation_schedule == 0:
            flush_pending()              # waits for the epochs queued before it
            logger.debug('epoch %d: validating', epoch)
            ssims, psnrs, v_losses, _ = validate(model, data, model.loss_metric)
            ssims, psnrs, v_losses = multihost.agree((ssims, psnrs, v_losses))
            model.log_metric('ssim', 'validation', ssims)
            model.log_metric('psnr', 'validation', psnrs)
            model.log_metric('loss', 'validation', v_losses)

            training_summary['Epoch'] = epoch
            if primary:
                save_progress(model, training_summary, out_directory)

            val_losses = model.performance['loss']['validation']
            if not save_best or (len(val_losses) > 2 and val_losses[-1] <= min(val_losses)):
                save_checkpoint(epoch)

            # drop the learning rate if the model deteriorated by > 20%
            if len(val_losses) > 5 and val_losses[-1] > 1.2 * min(val_losses):
                learning_rate = max(learning_rate * 0.95, 1e-7)

            logger.info('epoch %d: loss %.4f, validation psnr %.2f dB, ssim %.4f', epoch,
                        model.pop_metric('loss', 'training'),
                        model.pop_metric('psnr', 'validation'),
                        model.pop_metric('ssim', 'validation'))

            # convergence check
            if validation_loss_threshold is not None and len(val_losses) > 10:
                current = np.mean(val_losses[-N_TAIL:-1])
                previous = np.mean(val_losses[-(N_TAIL + 1):-2])
                vloss_change = abs((current - previous) / previous)
                if vloss_change < validation_loss_threshold:
                    logger.info('Early stopping - model converged, validation loss change %s',
                                vloss_change)
                    break

    flush_pending()
    training_summary['Epoch'] = epoch
    val_losses = model.performance['loss']['validation']
    if not save_best or (val_losses and val_losses[-1] <= min(val_losses)):
        save_checkpoint(epoch, quiet=False)
    if primary:
        save_progress(model, training_summary, out_directory)
    return out_directory
