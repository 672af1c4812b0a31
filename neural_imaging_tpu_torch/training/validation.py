"""
Validation of the workflow's parts and the ``training.json`` writer: port of
``validate_fan``, ``validate_nip``, ``validate_jpeg``, ``validate_dcn`` and
``save_training_progress`` of ``neural_imaging_tpu/training/validation.py``.

The networks run on the flow's device; the image metrics (``utils.metrics``:
skimage's SSIM and PSNR) run on the host in float64, as in the reference.
The reference's figures (``nip_validation_*.jpg``, ``dcn_validation_*.jpg``,
``visualize_manipulation_training``) need matplotlib and are not written.
"""
import os
from collections import OrderedDict

import numpy as np
import torch

from neural_imaging_tpu_torch.models.compression import DCN
from neural_imaging_tpu_torch.models.jpeg import JPEG
from neural_imaging_tpu_torch.utils import jsonlog, metrics
from neural_imaging_tpu_torch.utils.utils import logger


def validate_jpeg(jpeg_codec, data, batch_size=1):
    """Mean PSNR, SSIM and entropy of the JPEG codec over the validation set
    (the entropy is NaN for the 'libjpeg' codec, as in the reference)."""
    if not isinstance(jpeg_codec, JPEG):
        raise ValueError(f'Codec needs to be an instance of JPEG but is {type(jpeg_codec)}')

    batch_size = min(batch_size, data.count_validation)
    n_batches = data.count_validation // batch_size
    results = {k: [] for k in ('psnr', 'ssim', 'entropy')}

    for batch_id in range(n_batches):
        batch_x = data.next_validation_batch(batch_id, batch_size)
        if isinstance(batch_x, tuple):
            batch_x = batch_x[-1]
        batch_y, entropy = jpeg_codec.process(batch_x, return_entropy=True)
        batch_y = batch_y.cpu().numpy() if torch.is_tensor(batch_y) else batch_y  # libjpeg: numpy
        results['ssim'].append(metrics.batch(batch_x, batch_y, metrics.ssim))
        results['psnr'].append(metrics.batch(batch_x, batch_y, metrics.psnr))
        results['entropy'].append(entropy)

    return {k: float(np.mean(v)) for k, v in results.items()}


def validate_dcn(dcn, data):
    """Mean SSIM and PSNR, the loss and the entropy of a DCN over the
    validation set, decoded in one batch; None for a codec that is not a
    DCN."""
    if not isinstance(dcn, DCN):
        return None
    batch_x = data.next_validation_batch(0, data.count_validation)
    if isinstance(batch_x, tuple):
        batch_x = batch_x[-1]
    batch_y, entropy = dcn.process(batch_x, return_entropy=True)
    batch_y = batch_y.cpu().numpy()
    entropy = float(entropy)
    loss = float(dcn.loss(torch.from_numpy(batch_x), torch.from_numpy(batch_y), entropy))
    return {'ssim': float(np.mean(metrics.ssim(batch_x, batch_y))),
            'psnr': float(np.mean(metrics.psnr(batch_x, batch_y))),
            'loss': loss, 'entropy': entropy}


def validate_nip(model, data, loss_type='L2'):
    """Develop the validation patches; returns per-image (ssims, psnrs,
    losses). The reference's figure of them is not written."""
    example_x, example_y = data.validation_tensors(model.device)
    developed = model.process(example_x).clamp(0, 1).cpu().numpy()
    example_y = example_y.cpu().numpy()

    ssims, psnrs, losses = [], [], []
    for b in range(data.count_validation):
        reference, dev = example_y[b], developed[b]
        ssims.append(float(metrics.ssim(reference, dev)))
        psnrs.append(float(metrics.psnr(reference, dev)))
        if loss_type == 'L2':
            losses.append(float(np.mean((reference - dev) ** 2)))
        elif loss_type == 'L1':
            losses.append(float(np.mean(np.abs(reference - dev))))
        else:
            raise ValueError('Invalid loss! Use either L1 or L2.')
    return ssims, psnrs, losses


def validate_fan(flow, data, get_labels=False, randomize=False, repeats=1):
    """Accuracy and the n×n confusion matrix of the workflow's FAN on the
    validation set, in batches of up to 10 patches on the flow's device.

    ``randomize=True`` draws the manipulation strengths of each batch (the
    distribution the augmented trainer optimizes), and ``repeats`` passes
    over the validation set pool the accuracy and the confusion over draws.
    With ``get_labels`` also the predicted labels, in order."""
    batch_size = min(10, data.count_validation)
    n_batches = data.count_validation // batch_size
    n_classes = flow.n_classes
    validation_x = data.validation_tensors(flow.device)
    if isinstance(validation_x, tuple):
        validation_x = validation_x[0]

    predicted = []
    for batch in range(n_batches * max(1, repeats)):
        start = (batch % n_batches) * batch_size
        probs = flow.run_workflow(validation_x[start:start + batch_size], augment=randomize)[-1]
        predicted.append(probs.argmax(dim=1))
    predicted = torch.stack(predicted).cpu().numpy()          # one copy to the host
    labels = np.repeat(np.arange(n_classes), batch_size)
    conf = np.zeros((n_classes, n_classes))
    np.add.at(conf, (np.broadcast_to(labels, predicted.shape), predicted), 1)
    conf = conf / conf.sum(axis=1, keepdims=True).clip(min=1)
    accuracy = float(np.mean([np.mean(p == labels) for p in predicted]))
    if get_labels:
        return accuracy, conf, list(predicted.reshape(-1))
    return accuracy, conf


def save_training_progress(training_summary, flow, root_dir, quiet=False):
    """Write ``training.json``, which the JAX package's results tooling and
    ``test_fan.py`` read: {summary, distribution, channel_precision,
    manipulations, nip, forensics, codec}."""
    training = OrderedDict()
    training['summary'] = training_summary
    training['distribution'] = flow._distribution
    training['channel_precision'] = flow.channel_precision
    training['manipulations'] = flow._forensics_classes

    training['nip'] = OrderedDict(
        model=flow.nip.class_name, init=repr(flow.nip),
        args=flow.nip._h.to_json() if hasattr(flow.nip, '_h') else {},
        performance=flow.nip.performance)

    training['forensics'] = OrderedDict(
        model=flow.fan.class_name, init=repr(flow.fan),
        args=flow.fan._h.to_json(), performance=flow.fan.performance)

    if flow.codec is not None:
        training['codec'] = OrderedDict(model=flow.codec.class_name, init=repr(flow.codec))
        if hasattr(flow.codec, '_h'):
            training['codec']['args'] = flow.codec._h.to_json()
        training['codec']['performance'] = flow.codec.performance

    filename = os.path.join(root_dir, 'training.json')
    if not quiet:
        logger.info('> Training progress --> %s', filename)
    jsonlog.save_json(training, filename)
