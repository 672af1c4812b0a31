"""The whole manipulation-classification forward slice of the PyTorch port
against the JAX package's ``run_workflow``, from the shipped ``m_quality`` run
(INet → sharpen/resample/gaussian/jpeg:80 → pool → JPEG QF 50 → FAN) and the
``m_quality_qtables`` run (the same with a trainable JPEG channel), on the
CPU at raw patch 16 and batch 2.

Tolerances: at patch 16, images in [0, 1] agree to 1e-5 (float32, other
summation orders; a dJPEG coefficient flip would show here first);
probabilities to 1e-5 and their logarithms to 1e-3 where they exceed 1e-20.
At full width (raw patch 128) the probabilities are held with
``compare_probabilities``, the check chip_smoke.py applies between the GPU
and the CPU."""
import json
import os

import numpy as np
import pytest
import torch

from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu.workflows import ManipulationClassification as JaxFlow
import chip_smoke
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    DECISION_MARGIN, ManipulationClassification, compare_probabilities)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_DIR = os.path.join(ROOT, 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000')
# a run whose channel is a trainable JPEG ("JPEG (soft) trainable QF~50/50")
TRAINABLE_RUN_DIR = os.path.join(ROOT, 'data/m_quality_qtables/QualityRef/INet/fixed-nip/'
                                 'lc-0.1000/000')
PATCH = 16


def reference_flow(patch=PATCH, run_dir=RUN_DIR):
    """The JAX flow of the run, restored as test_fan.py restores one."""
    with open(os.path.join(run_dir, 'training.json')) as f:
        log = json.load(f)
    fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
    flow = JaxFlow('INet', manipulations=[m for m in log['manipulations'] if m != 'native'],
                   distribution=log['distribution'], fan_args=fan_args,
                   raw_patch_size=patch, nip_args=log['nip']['args'])
    flow.fan.load_model(os.path.join(run_dir, 'models/fan'))
    flow.nip.load_model(os.path.join(run_dir, 'models/inet'))
    flow.params = flow._collect_params()
    return flow


@pytest.fixture(scope='module')
def flows():
    return reference_flow(), ManipulationClassification.restore(RUN_DIR, PATCH, device='cpu')


def camera_batch(seed):
    """Raw patches of simulated camera captures (uint16 RGGB stacks → [0, 1])."""
    stacks = [fixtures.make_raw_rgb_pair(2 * PATCH, 2 * PATCH, seed=seed + i)[0]
              for i in range(2)]
    return (np.stack(stacks).astype(np.float32) / 65535.0)


def assert_slice_matches(ref, port, x):
    expected = ref.run_workflow(x)
    got = port.run_workflow(x)
    names = ('batch_Y', 'batch_c', 'batch_C', 'entropy', 'probabilities')
    for name, a, b in zip(names, expected, got):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, atol=1e-5, err_msg=name)
    probs = got[-1].numpy()
    keep = np.asarray(expected[-1]) > 1e-20
    np.testing.assert_allclose(np.log(probs[keep]), np.log(np.asarray(expected[-1])[keep]),
                               atol=1e-3)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(port.run_workflow_to_decisions(x),
                                  ref.run_workflow_to_decisions(x))


@pytest.mark.parametrize('inputs', ['camera', 'uniform'])
def test_slice_matches_reference(flows, inputs):
    x = (camera_batch(20) if inputs == 'camera'
         else np.random.default_rng(21).random((2, PATCH, PATCH, 4)).astype(np.float32))
    assert_slice_matches(*flows, x)


@pytest.fixture(scope='module')
def trainable_flows():
    return (reference_flow(run_dir=TRAINABLE_RUN_DIR),
            ManipulationClassification.restore(TRAINABLE_RUN_DIR, PATCH, device='cpu'))


def test_trainable_channel_is_restored_as_the_reference_restores_it(trainable_flows):
    ref, port = trainable_flows
    assert port.codec.trainable and ref.codec.trainable
    assert repr(port.codec) == repr(ref.codec) == 'JPEG(quality=50,codec="soft",trainable=True)'
    tables = port.codec._model.params
    assert tables['q_mtx_luma'].requires_grad
    np.testing.assert_array_equal(tables['q_mtx_luma'].detach().numpy(),
                                  ref.codec._model.q_mtx_luma)
    np.testing.assert_array_equal(tables['q_mtx_chroma'].detach().numpy(),
                                  ref.codec._model.q_mtx_chroma)


def test_trainable_channel_slice_matches_reference(trainable_flows):
    assert_slice_matches(*trainable_flows, camera_batch(30))


def test_restored_flow_shape(flows):
    _, port = flows
    assert port._forensics_classes == ['native', 'sharpen:1', 'resample:50', 'gaussian:0.83',
                                       'jpeg:80']
    assert port.n_classes == 5 and port.downsampling_factor == 2
    assert port.codec.quality == 50 and port.codec.codec == 'soft'
    assert port.fan.count_parameters() == 1_145_382


@pytest.mark.parametrize('kwargs', [
    {'distribution': {'compression_params': {'quality': 50, 'codec': 'libjpeg'}}},
    {'distribution': {'compression_params': {'quality': 50, 'codec': 'soft', 'dirname': 'x'}}},
])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        ManipulationClassification(raw_patch_size=PATCH, device='cpu', **kwargs)


def test_slice_at_full_width():
    x = chip_smoke.synthetic_raw(3, 4, 128)
    probs = ManipulationClassification.restore(RUN_DIR, 128, device='cpu').run_workflow(x)[-1]
    report = compare_probabilities(probs, np.asarray(reference_flow(128).run_workflow(x)[-1]))
    assert report['rows'] == 20 and report['decided_rows'] > 0


def test_compare_probabilities_flags_disagreement():
    p = np.array([[0.7, 0.2, 0.1], [0.5, 0.495, 0.005]])
    assert compare_probabilities(p, p)['decided_rows'] == 1
    compare_probabilities(p[:, [1, 0, 2]][1:], p[1:])       # undecided row may swap
    with pytest.raises(AssertionError):
        compare_probabilities(p + [[-0.02, 0.02, 0]], p)
    with pytest.raises(AssertionError):
        compare_probabilities(p[:, [1, 0, 2]], p)


# -- the other camera ISPs ------------------------------------------------------------

UNET_RUN_DIR = os.path.join(ROOT, 'data/m_quality_full/QualityRef/UNet/fixed-nip/fixed-codec/000')
NARROW_FAN = {'n_filters': 8, 'n_convolutions': 2}
MAX_FLIPPED_BLOCKS = 0.05
NARROW_NIPS = {'UNet': {'n_steps': 3}, 'DNet': {'n_layers': 3, 'n_features': 8},
               'ClassicISP': {'c_filters': (4,)}}


def narrow_flows(nip, **kwargs):
    """The JAX flow of a narrow NIP and FAN (their initial weights) and the
    port's with the same weights."""
    from flax import traverse_util
    from neural_imaging_tpu_torch.models import base
    ref = JaxFlow(nip, fan_args=NARROW_FAN, raw_patch_size=PATCH, nip_args=NARROW_NIPS[nip],
                  **kwargs)
    port = ManipulationClassification(nip, fan_args=NARROW_FAN, raw_patch_size=PATCH,
                                      nip_args=NARROW_NIPS[nip], device='cpu', **kwargs)
    for model, params in ((port.nip, ref.nip.params), (port.fan, ref.fan.params)):
        flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep='/').items()}
        model.module.load_state_dict(base.convert_params(flat, base.transposed_kernels(model.module)),
                                     strict=True)
    ref.params = ref._collect_params()
    port._snapshot()
    port.reinitialize()
    return ref, port


@pytest.mark.parametrize('nip', sorted(NARROW_NIPS))
def test_nip_flow_matches_reference(nip):
    """The whole slice with a UNet, DNet or ClassicISP as the NIP."""
    ref, port = narrow_flows(nip)
    assert port.nip.class_name == nip and port.summary() == ref.summary()
    assert_slice_matches(ref, port, camera_batch(40))


def test_unet_run_restores_as_the_reference_restores_it():
    """``restore`` of the m_quality_full UNet run (downsampling 'none', its
    unet.npz and fan.npz) against the JAX flow restored as test_fan.py
    restores it."""
    with open(os.path.join(UNET_RUN_DIR, 'training.json')) as f:
        log = json.load(f)
    fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
    patch = 64                                   # the run's own raw patch
    ref = JaxFlow('UNet', manipulations=[m for m in log['manipulations'] if m != 'native'],
                  distribution=log['distribution'], fan_args=fan_args, raw_patch_size=patch,
                  nip_args=log['nip']['args'])
    ref.fan.load_model(os.path.join(UNET_RUN_DIR, 'models/fan'))
    ref.nip.load_model(os.path.join(UNET_RUN_DIR, 'models/unet'))
    ref.params = ref._collect_params()
    port = ManipulationClassification.restore(UNET_RUN_DIR, patch, device='cpu')
    assert port.nip.model_code == 'UNet_5' and port.downsampling_factor == 1
    assert port.nip.count_parameters() == 7_763_820
    x = np.stack([fixtures.make_raw_rgb_pair(2 * patch, 2 * patch, seed=50 + i)[0]
                  for i in range(2)]).astype(np.float32) / 65535.0
    expected, got = ref.run_workflow(x), port.run_workflow(x)
    # UNet_5 saturates whole 8x8 blocks at 0 or 1, whose DC coefficients lie
    # on a rounding tie (a white block's 1016 / 16 = 63.5 at QF 50): the last
    # bit of the DCT's sums rounds them either way, and a flipped
    # coefficient moves its 8x8 block by a q step, which at this FAN's 128-px
    # input moves a row's probabilities by up to ~1e-2. So the channel's
    # output is held block by block (at most MAX_FLIPPED_BLOCKS of its blocks
    # differ, the others within 1e-5; measured 1.9%), the FAN on the
    # reference's own input as at full width (compare_probabilities), and the
    # decisions of the rows the reference decides
    for name, i in (('batch_Y', 0), ('batch_c', 1)):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(expected[i]), atol=1e-5,
                                   err_msg=name)
    diff = np.abs(got[2].numpy() - np.asarray(expected[2]))
    n, h, w, c = diff.shape
    blocks = diff.reshape(n, h // 8, 8, w // 8, 8, c).max(axis=(2, 4))
    assert np.mean(blocks > 1e-5) <= MAX_FLIPPED_BLOCKS
    compare_probabilities(port.fan.process(np.asarray(expected[2])),
                          np.asarray(ref.fan.process(expected[2])))
    p_ref = np.sort(np.asarray(expected[-1]), axis=1)
    decided = p_ref[:, -1] - p_ref[:, -2] > DECISION_MARGIN
    np.testing.assert_array_equal(got[-1].numpy().argmax(1)[decided],
                                  np.asarray(expected[-1]).argmax(1)[decided])


def test_nip_snapshot_in_the_model_name(tmp_path):
    """'<class>:<dir>' loads the NIP's weights from the snapshot directory."""
    from neural_imaging_tpu_torch.models import pipelines
    nip = pipelines.DNet(n_layers=2, n_features=8, device='cpu')
    nip.save_model(str(tmp_path / 'snap'))
    flow = ManipulationClassification(f'DNet:{tmp_path / "snap"}', raw_patch_size=PATCH,
                                      nip_args={'n_layers': 2, 'n_features': 8}, device='cpu')
    for (k, a), (_, b) in zip(sorted(nip.checkpoint().items()),
                              sorted(flow.nip.checkpoint().items())):
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize('kwargs', [{'nip_model': 'XNet'}, {'loss_metric': 'MS-SSIM'}])
def test_flow_refuses_unknown_nips_and_losses(kwargs):
    with pytest.raises(ValueError):
        ManipulationClassification(raw_patch_size=PATCH, device='cpu', **kwargs)
