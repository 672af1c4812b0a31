"""The whole manipulation-classification forward slice of the PyTorch port
against the JAX package's ``run_workflow``, from the shipped ``m_quality`` run
(INet → sharpen/resample/gaussian/jpeg:80 → pool → JPEG QF 50 → FAN), on the
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
    ManipulationClassification, compare_probabilities)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_DIR = os.path.join(ROOT, 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000')
PATCH = 16


def reference_flow(patch=PATCH):
    """The JAX flow of the run, restored as test_fan.py restores one."""
    with open(os.path.join(RUN_DIR, 'training.json')) as f:
        log = json.load(f)
    fan_args = {k: v for k, v in log['forensics']['args'].items() if k != 'n_classes'}
    flow = JaxFlow('INet', manipulations=[m for m in log['manipulations'] if m != 'native'],
                   distribution=log['distribution'], fan_args=fan_args,
                   raw_patch_size=patch, nip_args=log['nip']['args'])
    flow.fan.load_model(os.path.join(RUN_DIR, 'models/fan'))
    flow.nip.load_model(os.path.join(RUN_DIR, 'models/inet'))
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


@pytest.mark.parametrize('inputs', ['camera', 'uniform'])
def test_slice_matches_reference(flows, inputs):
    ref, port = flows
    x = (camera_batch(20) if inputs == 'camera'
         else np.random.default_rng(21).random((2, PATCH, PATCH, 4)).astype(np.float32))
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


def test_restored_flow_shape(flows):
    _, port = flows
    assert port.forensics_classes == ['native', 'sharpen:1', 'resample:50', 'gaussian:0.83',
                                      'jpeg:80']
    assert port.n_classes == 5 and port.downsampling_factor == 2
    assert port.codec.quality == 50 and port.codec.codec == 'soft'
    assert port.fan.count_parameters() == 1_145_382


@pytest.mark.parametrize('kwargs', [
    {'distribution': {'downsampling': 'bilinear'}},
    {'distribution': {'compression': 'dcn'}},
    {'manipulations': ['awgn']},
    {'nip_model': 'UNet'},
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
