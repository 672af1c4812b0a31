"""The port's re-validation CLI (``neural_imaging_tpu_torch.cli.test_fan``)
against the repository's ``test_fan.py``, on the CPU: its ``restore_flow``
with every override, the six shipped runs with weights that no other test
holds, and both CLIs end to end on one fixture directory.

Tolerances: the shipped runs' probabilities by ``compare_probabilities``
(|Δp| ≤ 1e-2, the same decisions where the top two differ by more than
2e-2) with the FAN of each package on the reference's own developed RGB, as
``test_torch_precision.test_restore_shipped_run_as_the_reference`` holds
its four runs. At raw 64 a channel coefficient on a rounding tie may flip
between the packages and move its row by ~2e-2: where the channel's output
differs, at most ``MAX_FLIPPED_BLOCKS`` of its 8x8 blocks may, the FANs are
held on the reference's channel output, and every decided row keeps its
decision. The CLIs print the same accuracies and confusion tables: the
port's awgn noise is replaced there by the reference's draws from its key
(PyTorch cannot reproduce JAX's generator), everything else is the port's.
"""
import argparse
import json
import os
import re
import shutil
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu_torch.cli import test_fan as port_test_fan
from neural_imaging_tpu_torch.cli import train_manipulation as port_cli
from neural_imaging_tpu_torch.utils import results_data
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    DECISION_MARGIN, ManipulationClassification, compare_probabilities)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import test_fan  # noqa: E402  (the JAX package's re-validation CLI)
from neural_imaging_tpu.utils import results_data as jresults  # noqa: E402

torch.set_num_threads(1)

NIP_DIR = os.path.join(ROOT, 'data/models/nip')
QUALITY_RUN = os.path.join(ROOT, 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000')
# the shipped runs with weights that no other test restores
SIX = {name: os.path.join(ROOT, 'data', path) for name, path in {
    'm_aug_high': 'm_aug_high/QualityRef/INet/ln-0.0050/fixed-codec/000',
    'm_aug_long': 'm_aug_long/QualityRef/INet/ln-0.0050/fixed-codec/000',
    'm_noaug_long': 'm_noaug_long/QualityRef/INet/ln-0.0050/fixed-codec/000',
    'm_prec_cjb16': 'm_prec_cjb16/QualityRef/INet/ln-0.0050/fixed-codec/000',
    'm_quality_full': 'm_quality_full/QualityRef/INet/fixed-nip/fixed-codec/000',
    'm_quality_qtables': 'm_quality_qtables/QualityRef/INet/fixed-nip/lc-0.0050/000',
}.items()}
RAW_PATCH = 64
MAX_FLIPPED_BLOCKS = 0.05
SEVEN = 'sharpen,resample,gaussian,jpeg,awgn,gamma,median'
FAN_ARGS = {'n_convolutions': 2, 'n_filters': 8, 'n_dense': 0}
PATCH = 16


def overrides(patch=RAW_PATCH, **kwargs):
    """``test_fan.py``'s overrides as its parser gives them, and the port's
    device (which the reference does not read)."""
    args = dict(jpeg=None, codec=None, dcn=None, ds=None, manip=None, patch=patch,
                channel_dtype=None, channel_jpeg_dtype=None, manip_jpeg_dtype=None,
                device='cpu')
    return argparse.Namespace(**{**args, **kwargs})


def both_flows(run_dir, args):
    training_json = os.path.join(run_dir, 'training.json')
    port, expected = port_test_fan.restore_flow(training_json, args)
    ref, ref_expected = test_fan.restore_flow(training_json, args)
    assert expected == ref_expected or (np.isnan(expected) and np.isnan(ref_expected))
    return port, ref


# -- the six shipped runs ---------------------------------------------------------------------

@pytest.mark.parametrize('run', list(SIX))
def test_shipped_run_restores_as_the_reference(run):
    """Each run through both packages' ``restore_flow`` at raw 64: the same
    classes, distribution and FAN arguments, then the same developed RGB
    (the reference's INet) through each package's manipulations, channel
    and FAN."""
    port, ref = both_flows(SIX[run], overrides())
    assert port._forensics_classes == ref._forensics_classes
    assert port._distribution == ref._distribution
    assert port.fan._h.to_json() == ref.fan._h.to_json()
    x = np.stack([fixtures.make_raw_rgb_pair(2 * RAW_PATCH, 2 * RAW_PATCH, seed=60 + i)[0]
                  for i in range(2)]).astype(np.float32) / 65535.0
    batch_Y = np.asarray(ref.nip.process(x))
    fan_input, fan_input_ref = port.run_rgb_to_fan(batch_Y), np.asarray(ref.run_rgb_to_fan(batch_Y))
    probs = port.fan.process(fan_input).numpy()
    probs_ref = np.asarray(ref.fan.process(fan_input_ref))
    diff = np.abs(fan_input - fan_input_ref)
    n, h, w, c = diff.shape
    flipped = diff.reshape(n, h // 8, 8, w // 8, 8, c).max(axis=(2, 4)) > 1e-5
    if not flipped.any():
        compare_probabilities(probs, probs_ref)
        return
    assert flipped.mean() <= MAX_FLIPPED_BLOCKS, flipped.mean()
    compare_probabilities(port.fan.process(fan_input_ref).numpy(), probs_ref)
    top2 = np.sort(probs_ref, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > DECISION_MARGIN
    np.testing.assert_array_equal(probs.argmax(1)[decided], probs_ref.argmax(1)[decided])


# -- restore_flow's overrides -----------------------------------------------------------------

@pytest.mark.parametrize('kwargs', [
    {'jpeg': 30}, {'jpeg': 70, 'codec': 'sin'}, {'codec': 'harmonic'}, {'ds': 'none'},
    {'ds': 'bilinear'}, {'manip': 'sharpen:2,resample:60,gaussian:1.5,jpeg:70'},
    {'dcn': '32c', 'ds': 'none'}, {'channel_dtype': 'bfloat16', 'manip_jpeg_dtype': 'bfloat16'},
    {'channel_jpeg_dtype': 'bfloat16'},
], ids=['jpeg', 'jpeg-codec', 'codec', 'ds-none', 'ds-bilinear', 'manip', 'dcn', 'dtypes',
        'channel-jpeg-dtype'])
def test_restore_flow_takes_the_reference_overrides(kwargs):
    """Each override builds what the reference's ``restore_flow`` builds."""
    port, ref = both_flows(QUALITY_RUN, overrides(patch=PATCH, **kwargs))
    assert port._distribution == ref._distribution
    assert port._forensics_classes == ref._forensics_classes
    assert port.summary() == ref.summary()
    assert port.channel_precision == {
        'channel_dtype': 'bfloat16' if ref._channel_dtype == jnp.bfloat16 else 'float32',
        'channel_jpeg_dtype': 'bfloat16' if ref._channel_jpeg_bf16 else 'float32',
        'manip_jpeg_dtype': 'bfloat16' if ref._manip_jpeg_bf16 else 'float32'}


def test_restore_flow_takes_libjpeg():
    """``--codec libjpeg`` builds what the reference builds: a host libjpeg
    codec whose channel rounds 'soft' inside the flow, so the run classifies
    as with the 'soft' codec, bit for bit."""
    port, ref = both_flows(QUALITY_RUN, overrides(patch=PATCH, codec='libjpeg'))
    assert port.codec._model is None and repr(port.codec) == repr(ref.codec)
    assert port.summary() == ref.summary()
    soft, _ = port_test_fan.restore_flow(os.path.join(QUALITY_RUN, 'training.json'),
                                         overrides(patch=PATCH, codec='soft'))
    x = np.random.default_rng(5).random((2, PATCH, PATCH, 4)).astype(np.float32)
    with torch.no_grad():
        torch.testing.assert_close(port.run_workflow(x)[-1], soft.run_workflow(x)[-1],
                                   rtol=0, atol=0)


def test_confusion_text_matches_reference():
    conf = np.random.default_rng(0).random((8, 8)) * 100
    labels = ['native', 'sharpen:1', 'resample:50', 'gaussian:0.83', 'jpeg:80', 'awgn:5.1',
              'gamma:3', 'median:3']
    assert (results_data.confusion_to_text(conf, labels, title='t')
            == jresults.confusion_to_text(conf, labels, title='t'))


# -- both CLIs on one fixture directory -------------------------------------------------------

@pytest.fixture(scope='module')
def scan(tmp_path_factory):
    """A fixture dataset and a directory of three runs: the shipped 5-class
    m_quality run, an 8-class INet run and an 8-class ONet run, the last two written
    by the port's ``train_manipulation`` CLI (2 epochs at raw 16, lr 1e-2)
    with all seven manipulations. The INet run's FAN still calls every
    patch sharpen; the ONet run's spreads its calls over the classes."""
    root = tmp_path_factory.mktemp('scan')
    data_dir = fixtures.make_dataset(str(root / 'data'), n_images=6, height=64, width=96,
                                     seed=700)
    runs = root / 'runs'
    shutil.copytree(QUALITY_RUN, runs / 'shipped')
    common = ['--data', data_dir, '--split', '4:2:2', '--epochs', '2', '--patch', str(PATCH),
              '--lr', '1e-2',
              '--batch', '2', '--val-schedule', '1', '--fan', json.dumps(FAN_ARGS),
              '--nip-dir', NIP_DIR, '--device', 'cpu', '--jpeg', '50']
    port_cli.main(['--nip', 'INet', '--cam', 'SyntheticCam', '--manip', SEVEN,
                   '--dir', str(runs / 'eight'), *common])
    port_cli.main(['--nip', 'ONet', '--cam', 'SyntheticCam', '--manip', SEVEN,
                   '--ds', 'none', '--dir', str(runs / 'onet'), *common])
    return data_dir, runs


def reference_noise(monkeypatch):
    """Make every port flow draw awgn's noise as the reference's flow built
    with ``rng_seed`` 0 draws it: one split of the flow's key per forward,
    then one per manipulation in class order, awgn's normal from its own."""
    keys = weakref.WeakKeyDictionary()

    def noise(flow, shape, dtype):
        if 'awgn' not in flow._operations:
            return None
        key, sub = jax.random.split(keys.get(flow, jax.random.PRNGKey(0)))
        keys[flow] = key
        for name in flow._operations:
            sub, own = jax.random.split(sub)
            if name == 'awgn':
                n, c, h, w = shape
                drawn = np.asarray(jax.random.normal(own, (n, h, w, c)))
                return torch.from_numpy(drawn.transpose(0, 3, 1, 2).copy()).to(dtype)

    monkeypatch.setattr(ManipulationClassification, '_awgn_noise', noise)


def results(text):
    """(summary, accuracy line, confusion table) of each run a CLI printed."""
    blocks = re.split(r'\n(?=ManipulationClassification\[)', text)
    out = []
    for block in blocks:
        match = re.search(r'Accuracy validated/expected: (\S+) / (\S+)\n\n(# .*?)(?:\n\n|\Z)',
                          block, re.S)
        if match:
            out.append((block.splitlines()[0], match.group(1), match.group(2),
                        match.group(3).strip()))
    return out


def test_cli_matches_reference_cli(scan, capsys, monkeypatch):
    """``--dir`` over the three runs in both CLIs: the same runs found and
    validated, each on the right dataset mode (an ONet run on the RGB
    images, 'y'; the others on RAW, 'xy'), with the same accuracy and the
    same confusion table; and ``--run-dir`` of the 8-class run alone."""
    data_dir, runs = scan
    argv = ['--dir', str(runs), '--data', data_dir, '--patch', str(PATCH)]
    reference_noise(monkeypatch)
    assert port_test_fan.main(argv + ['--device', 'cpu']) == 0
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['test_fan.py'] + argv)
    test_fan.main()
    ref_out = capsys.readouterr().out
    got, expected = results(port_out), results(ref_out)
    assert len(got) == 3 and got == expected
    assert 'Data (xy)' in port_out and 'Data (y)' in port_out
    assert sorted(int(r[0].split('(prob. ')[1].split()[0]) for r in got) == [5, 8, 8]

    run = next(str(p.parent) for p in runs.glob('eight/**/training.json'))
    assert port_test_fan.main(['--run-dir', run, '--data', data_dir, '--patch', str(PATCH),
                               '--device', 'cpu']) == 0
    alone = results(capsys.readouterr().out)
    assert alone == [r for r in got if '-> INet -> 7 manipulations' in r[0]]
