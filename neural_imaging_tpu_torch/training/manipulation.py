"""
The joint workflow's trainer: port of ``neural_imaging_tpu/training/manipulation.py``.

It keeps the reference's run directory (``root/camera/NIP/{ln-*|fixed-nip}/
{lc-*|fixed-codec}/NNN`` with ``training.json`` and ``models/<model>/
<class>.npz``, which the JAX package's ``test_fan.py`` and results tooling
read), the pre-trained NIP from ``nip_snapshots/<camera>/<model_code>``, the
learning rate's decay by 0.9 every 100 epochs, and validation, the log and
snapshots every ``validation_schedule`` epochs and at the end.

Batches come from the host (``EpochPrefetcher``: sampled on a thread,
copied ahead) or, with ``device_data=True``, from the whole training set on
the device (``DeviceSampler`` and one ``flow.training_scan`` an epoch).
A trainable channel is validated at each validation point (a learned
codec also at the end) and snapshotted with the run; at the end a learned
codec's snapshot gets a ``progress.json``, copied from its source directory
or written anew, so that it restores as a codec on its own.

Losses stay on the device between validation points, where one copy brings
them to the host. Progress is one log line per validation point, and a
debug line where each validation starts, once the epochs before it have
run on the device. The reference's figures need matplotlib and
are not written; its ``parallel`` trainer is not ported.
"""
import os
import shutil
from collections import OrderedDict

import torch

from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.data.prefetch import EpochPrefetcher
from neural_imaging_tpu_torch.models.compression import DCN
from neural_imaging_tpu_torch.training import validation
from neural_imaging_tpu_torch.training.compression import save_progress as save_codec_progress
from neural_imaging_tpu_torch.utils import utils
from neural_imaging_tpu_torch.utils.utils import logger

LR_DECAY_SCHEDULE = 100
LR_DECAY_RATE = 0.90


def default_training_specs():
    return {
        'use_pretrained_nip': True,
        'patch_size': 64,
        'batch_size': 10,
        'validation_schedule': 50,
        'n_epochs': 1001,
        'learning_rate': 1e-4,
        'run_number': 0,
        'lambda_nip': 0.1,
        'lambda_dcn': 0,
        'augment': False,
    }


def train_manipulation_nip(flow, training, data, directories=None, overwrite=False,
                           parallel=None, nan_check=False, device_data=False):
    """Train the manipulation-classification workflow ``flow`` on ``data`` (a
    ``Dataset``) as ``training`` specifies (see ``default_training_specs``;
    ``camera_name`` is required). Returns the run's model directory; an
    existing run directory is kept unless ``overwrite``.

    ``nan_check=True`` fails on the step whose gradient is not finite; by
    default the check waits for the next validation point. ``device_data``
    trains from the training set on the flow's device."""
    if parallel is not None:
        raise NotImplementedError('the parallel trainer is not ported (ROADMAP.md §1 item 5); '
                                  'train on one device')
    dirs = {'root': './data/m/', 'nip_snapshots': './data/models/nip/'}
    if directories is not None:
        dirs.update(directories)
    directories = dirs

    spec = default_training_specs()
    if training is not None:
        spec.update(training)
    training = spec

    required = {'camera_name', 'use_pretrained_nip', 'lambda_nip', 'lambda_dcn',
                'run_number', 'n_epochs', 'learning_rate', 'augment'}
    missing = required.difference(training.keys())
    if missing:
        raise RuntimeError(f'Missing keys in the training dictionary! {missing}')
    if data is None:
        raise ValueError('Training data seems not to be loaded!')

    # dataset sanity check
    try:
        if data.is_raw_and_rgb():
            bx, by = data.next_training_batch(0, 1, training['patch_size'] * 2)
            expected = (1, training['patch_size'], training['patch_size'], 4)
            if bx.shape != expected:
                raise ValueError(f'The RAW+RGB training batch is of invalid size! {bx.shape}')
        else:
            bx = data.next_training_batch(0, 1, training['patch_size'] * 2)
            if bx.shape != (1, 2 * training['patch_size'], 2 * training['patch_size'], 3):
                raise ValueError(f'The RGB training batch is of invalid size! {bx.shape}')
    except Exception as e:
        raise ValueError(f'Data set error: {e}') from e

    logger.info('Training manipulation classification: cam=%s / ln=%.4f / run=%3d / '
                'epochs=%d, root=%s', training['camera_name'], training['lambda_nip'],
                training['run_number'], training['n_epochs'], directories['root'])

    save_dir = [directories['root'], training['camera_name'], flow.nip.class_name]
    save_dir.append('ln-{:0.4f}'.format(training['lambda_nip'])
                    if flow.is_trainable('nip') else 'fixed-nip')
    save_dir.append('lc-{:0.4f}'.format(training['lambda_dcn'])
                    if flow.is_trainable('dcn') else 'fixed-codec')
    save_dir.append('{:03d}'.format(training['run_number']))
    save_dir = os.path.join(*save_dir)
    model_directory = os.path.join(save_dir, 'models')
    logger.info('(progress) -> %s', save_dir)
    logger.info('(model) ----> %s', model_directory)

    if os.path.exists(save_dir) and not overwrite:
        logger.debug('Directory exists, skipping...')
        return model_directory

    if flow.is_trainable('nip') and flow.nip.count_parameters() == 0:
        raise ValueError('Trying to optimize a NIP with no trainable parameters!')

    learning_rate = training['learning_rate']
    n_batches = data.count_training // training['batch_size']
    if n_batches == 0:
        raise ValueError(
            f'Batch size ({training["batch_size"]}) exceeds dataset size '
            f'({data.count_training}) — zero training batches per epoch!')

    if training['use_pretrained_nip'] and flow.nip.count_parameters() > 0:
        nip_dirname = os.path.join(directories['nip_snapshots'],
                                   training['camera_name'], flow.nip.model_code)
        logger.debug('Loading camera model from %s', nip_dirname)
        flow.nip.load_model(nip_dirname)

    flow.nan_check = nan_check
    models = {'nip': flow.nip, 'fan': flow.fan}
    pending = {key: [] for key in models}    # per-epoch mean losses, on the device

    def flush_pending():
        """One device → host copy for all epochs since the last flush."""
        if not pending['fan']:
            return
        for key, values in pending.items():
            for v in torch.stack(values).double().cpu().numpy():
                models[key].log_metric('loss', 'training', float(v))
            values.clear()

    training_summary = OrderedDict()
    training_summary['Problem'] = flow.summary()
    training_summary['Dataset'] = data.summary()
    training_summary['Camera name'] = training['camera_name']
    training_summary['Classes'] = f'{flow._forensics_classes}'
    training_summary['FAN model'] = flow.fan.summary()
    training_summary['NIP model'] = flow.nip.summary()
    training_summary['Channel Downsampling'] = flow._distribution['downsampling']
    training_summary['Channel Compression'] = (flow.codec.summary()
                                               if flow.codec is not None else 'n/a')
    training_summary['Joint optimization'] = f'{flow.trainable_models}'
    training_summary['NIP Regularization'] = utils.format_number(training['lambda_nip'])
    training_summary['DCN Regularization'] = utils.format_number(training['lambda_dcn'])
    training_summary['NIP loss'] = f'{flow.nip.loss_metric}'
    training_summary['Use pre-trained NIP'] = str(training['use_pretrained_nip'])
    training_summary['# Epochs'] = utils.format_number(training['n_epochs'])
    training_summary['Patch size'] = utils.format_number(training['patch_size'])
    training_summary['Batch size'] = utils.format_number(training['batch_size'])
    training_summary['Learning rate'] = utils.format_number(training['learning_rate'])
    training_summary['Validation schedule'] = training['validation_schedule']
    training_summary['Augmentation'] = str(training['augment'])

    print('')
    for k, v in training_summary.items():
        print(f'{k:30s}: {v}')
    print('', flush=True)
    logger.info('Validation figures need matplotlib and are not written')

    def validate(epoch, final=False):
        """Validate the FAN, the NIP and a trainable codec; write the log and
        the snapshots."""
        flow.assert_finite()
        flush_pending()              # waits for the epochs queued before it
        logger.debug('epoch %d: validating', epoch)
        accuracy, conf = validation.validate_fan(flow, data)
        flow.fan.log_metric('accuracy', 'validation', accuracy)
        flow.fan.performance['confusion'] = conf.tolist()
        if flow.is_trainable('nip'):
            values = validation.validate_nip(
                flow.nip, data, loss_type='L2' if final else flow.nip.loss_metric)
            for metric, vals in zip(['ssim', 'psnr', 'loss'], values):
                flow.nip.log_metric(metric, 'validation', vals)
        # a trainable codec is validated and saved at every point; q-tables not at the end
        learned_codec = isinstance(flow.codec, DCN)
        codec_point = flow.is_trainable('dcn') and (learned_codec or not final)
        if codec_point:
            values = (validation.validate_dcn(flow.codec, data) if learned_codec
                      else validation.validate_jpeg(flow.codec, data))
            for metric, value in values.items():
                flow.codec.log_metric(metric, 'validation', value)

        validation.save_training_progress(training_summary, flow, save_dir, quiet=not final)
        if final:
            logger.info('Saving models...')
        flow.fan.save_model(os.path.join(model_directory, flow.fan.scoped_name), epoch,
                            quiet=not final)
        if flow.nip.count_parameters() > 0:
            # the FAN learned on this NIP's output: a run directory restores both
            flow.nip.save_model(os.path.join(model_directory, flow.nip.scoped_name), epoch,
                                quiet=not final)
        if codec_point:
            codec_dir = os.path.join(model_directory, flow.codec.scoped_name)
            flow.codec.save_model(codec_dir, epoch, quiet=not final)
            if learned_codec and final:
                # the snapshot restores as a codec: its log from the source, or a new one
                source = os.path.join(flow._distribution['compression_params']['dirname'],
                                      flow.codec.scoped_name, 'progress.json')
                if os.path.isfile(source):
                    shutil.copyfile(source, os.path.join(codec_dir, 'progress.json'))
                else:
                    save_codec_progress(flow.codec, data, dict(training), codec_dir)
        losses = flow.fan.performance['loss']['training']
        logger.info('epoch %d%s: loss %.4f, accuracy %.3f%s', epoch, ' (final)' if final else '',
                    losses[-1] if losses else float('nan'), accuracy,
                    (f", NIP psnr {flow.nip.performance['psnr']['validation'][-1]:.2f} dB"
                     if flow.is_trainable('nip') else ''))

    prefetcher = EpochPrefetcher(data, training['batch_size'], 2 * training['patch_size'],
                                 flow.device, discard='flat')
    sampler = None
    if device_data:
        sampler = DeviceSampler(data, training['batch_size'], 2 * training['patch_size'],
                                discard='flat', device=flow.device)
        logger.info('Training from device-resident data (%d images on %s)',
                    sampler.n_images, flow.device)

    epoch = 0
    for epoch in range(training['n_epochs']):
        if sampler is not None:
            fan_losses, nip_losses = flow.training_scan(
                sampler, sampler.epoch_steps(), training['lambda_nip'], training['lambda_dcn'],
                training['augment'], learning_rate)
        else:
            fan_losses, nip_losses = [], []
            for batch in prefetcher:
                batch_x, batch_y = batch if data._loaded_data == 'xy' else (batch, batch)
                comb_loss, comp_loss = flow.training_step(
                    batch_x, batch_y, training['lambda_nip'], training['lambda_dcn'],
                    training['augment'], learning_rate)
                fan_losses.append(comb_loss)
                nip_losses.append(comp_loss['nip'])
            fan_losses, nip_losses = torch.stack(fan_losses), torch.stack(nip_losses)
        pending['fan'].append(fan_losses.mean())
        pending['nip'].append(nip_losses.mean())

        if epoch % training['validation_schedule'] == 0:
            validate(epoch)

        if epoch % LR_DECAY_SCHEDULE == 0:
            learning_rate *= LR_DECAY_RATE

    validate(epoch, final=True)
    return model_directory
