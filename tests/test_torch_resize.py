"""The DCN trainer's resize augmentation: the port's INTER_AREA resize
(``utils/image.resize_area``) against ``cv2.resize(..., INTER_AREA)`` at
every size the trainer draws, and ``train_dcn`` with the resize always on
against the JAX package's trainer, which resizes with OpenCV.

Tolerances: the resize within 1e-6 of OpenCV's (its float32 sums against the
port's float64 ones); the first epoch's mean loss within 1e-3 relative (the
same batches, as ``tests/test_torch_dcn_trainer.py`` holds the trainer
without the resize)."""
import os

import cv2
import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.data import fixtures as jfixtures
from neural_imaging_tpu.data.dataset import Dataset as JaxDataset
from neural_imaging_tpu.models import compression as jcompression
from neural_imaging_tpu.training import compression as jtraining
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.models import base, compression
from neural_imaging_tpu_torch.training import compression as training
from neural_imaging_tpu_torch.utils import jsonlog
from neural_imaging_tpu_torch.utils.image import resize_area

torch.set_num_threads(1)

RESIZE_ATOL, EPOCH_LOSS_RTOL = 1e-6, 1e-3
PATCH, BATCH = 32, 4
SPLIT = dict(n_images=8, v_images=2, val_rgb_patch_size=32, val_n_patches=2)
SPEC = {'n_epochs': 2, 'batch_size': BATCH, 'patch_size': PATCH, 'validation_schedule': 1,
        'learning_rate': 1e-4,
        'augmentation_probs': {'resize': 1.0, 'flip_h': 0.5, 'flip_v': 0.5, 'gamma': 0.5}}


@pytest.mark.parametrize('patch', [16, 64])
def test_resize_area_matches_opencv_at_every_drawn_size(patch):
    """Every size in [patch, 2·patch) the trainer draws, shrunk to patch."""
    rng = np.random.default_rng(patch)
    for size in range(patch, 2 * patch):
        batch = rng.random((2, size, size, 3)).astype(np.float32)
        got = resize_area(batch, patch)
        assert got.shape == (2, patch, patch, 3) and got.dtype == np.float32
        for image, out in zip(batch, got):
            want = cv2.resize(image, (patch, patch), interpolation=cv2.INTER_AREA)
            np.testing.assert_allclose(out, want, rtol=0, atol=RESIZE_ATOL, err_msg=str(size))


def test_resize_area_of_rectangles_and_refusals():
    image = np.random.default_rng(1).random((37, 50, 3)).astype(np.float32)
    want = cv2.resize(image, (20, 20), interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(resize_area(image, 20), want, rtol=0, atol=RESIZE_ATOL)
    np.testing.assert_array_equal(resize_area(image[:20, :20], 20), image[:20, :20])
    with pytest.raises(ValueError, match='only shrinks'):
        resize_area(image, 40)


def test_train_dcn_with_resize_matches_the_reference(tmp_path):
    data_dir = jfixtures.make_dataset(str(tmp_path / 'rgb'), n_images=10, height=80, width=96,
                                      seed=710, rgb_only=True)
    ref = jcompression.TwitterDCN(patch_size=PATCH, n_features=8, use_pallas_quantization=True)
    port = compression.TwitterDCN(patch_size=PATCH, n_features=8, device='cpu')
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(ref.params, sep='/').items()}
    port.module.load_state_dict(base.convert_params(flat), strict=True)
    ref_dir = jtraining.train_dcn(ref, dict(SPEC), JaxDataset(data_dir, load='y', **SPLIT),
                                  directory=str(tmp_path / 'jax'), rng=np.random.default_rng(5))
    port_dir = training.train_dcn(port, dict(SPEC), Dataset(data_dir, load='y', **SPLIT),
                                  directory=str(tmp_path / 'port'), rng=np.random.default_rng(5))
    ref_perf, perf = (jsonlog.load_json(os.path.join(d, 'progress.json'))['codec']['performance']
                      for d in (ref_dir, port_dir))
    assert len(perf['loss']['training']) == len(ref_perf['loss']['training']) == 2
    first, first_ref = perf['loss']['training'][0], ref_perf['loss']['training'][0]
    assert abs(first - first_ref) <= EPOCH_LOSS_RTOL * abs(first_ref), (first, first_ref)
    assert np.isfinite(perf['ssim']['validation']).all()


def test_host_batch_draws_the_resize_as_the_reference():
    """The draw order of one host-fed batch: resize (then its size), flip h,
    flip v, gamma; a drawn size above the patch is shrunk to it."""
    class Data:
        sizes = []

        def next_training_batch(self, batch_id, batch_size, patch):
            self.sizes.append(patch)
            return np.full((batch_size, patch, patch, 3), 0.5, np.float32)

    data = Data()
    spec = {**SPEC, 'augmentation_probs': {'resize': 1.0, 'flip_h': 0.0, 'flip_v': 0.0,
                                           'gamma': 0.0}}
    rng, check = np.random.default_rng(9), np.random.default_rng(9)
    batch = training._host_batch(data, 0, spec, rng)
    check.uniform()
    assert data.sizes == [int(check.integers(PATCH, 2 * PATCH))]
    assert batch.shape == (BATCH, PATCH, PATCH, 3)
    np.testing.assert_allclose(batch, 0.5, atol=1e-7)
    for _ in range(3):
        check.uniform()
    assert rng.uniform() == check.uniform()
