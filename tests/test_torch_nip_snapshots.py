"""The shipped NIP snapshots and the weight carrier between the JAX
package's npz format and the port's parameters, on the CPU.

``base.restore`` of each shipped snapshot (QualityRef's UNet_5,
DNet_3x3_15x64f, ClassicISP and INet, QualityNoisy's ClassicISP with its
demosaicing CNN) develops the same raw batch at raw 32 in both packages
within ``SHIPPED_ATOL`` (UNet_5's 23 convolutions of up to 512 channels sum
in another order; measured at most 1.7e-6). The npz round trip is bit-exact,
and an npz the port writes develops within ``FWD_ATOL`` in the JAX
package."""
import os

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu.models import base as jbase
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu_torch.models import base, pipelines

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOTS = {name: os.path.join(ROOT, path) for name, path in {
    'UNet_5': 'data/models/nip/QualityRef/UNet_5',
    'DNet_3x3_15x64f': 'data/models/nip/QualityRef/DNet_3x3_15x64f',
    'ClassicISP_gbrg_5x5_-3R': 'data/models/nip/QualityRef/ClassicISP_gbrg_5x5_-3R',
    'ClassicISP_gbrg_5x5_16-16-3R': 'data/models/nip_noisy/QualityNoisy/'
                                    'ClassicISP_gbrg_5x5_16-16-3R',
    'INet_gbrg_5x5': 'data/models/nip/QualityRef/INet_gbrg_5x5'}.items()}
FWD_ATOL, SHIPPED_ATOL = 1e-5, 2e-5


def raw_batch(seed, n=2, p=16):
    return np.random.default_rng(seed).random((n, p, p, 4)).astype(np.float32)


# -- shipped snapshots and the weight carrier --------------------------------------------

@pytest.mark.parametrize('snapshot', sorted(SNAPSHOTS))
def test_shipped_snapshot_matches_reference(snapshot):
    """``base.restore`` of each shipped NIP in both packages, at raw 32."""
    ref = jbase.restore(SNAPSHOTS[snapshot], jpipelines, patch_size=32)
    port = base.restore(SNAPSHOTS[snapshot], pipelines, patch_size=32, device='cpu')
    assert port.model_code == ref.model_code == snapshot
    assert port.count_parameters() == ref.count_parameters()
    x = np.stack([fixtures.make_raw_rgb_pair(64, 64, seed=s)[0] for s in (18, 19)])
    x = x.astype(np.float32) / 65535.0
    np.testing.assert_allclose(port.process(x).numpy(), np.asarray(ref.process(x)),
                               atol=SHIPPED_ATOL)


@pytest.mark.parametrize('snapshot', sorted(SNAPSHOTS))
def test_weight_carrier_round_trip(snapshot):
    """npz → the port's parameters → npz gives the same arrays, bit for bit."""
    model = base.restore(SNAPSHOTS[snapshot], pipelines, device='cpu')
    npz = base.load_flax_npz(os.path.join(SNAPSHOTS[snapshot], model.scoped_name,
                                          f'{model.scoped_name}.npz'))
    written = model.checkpoint()
    assert written.keys() == npz.keys()
    for k, v in npz.items():
        assert written[k].shape == v.shape, k
        np.testing.assert_array_equal(written[k], v, err_msg=k)


def test_transposed_conv_kernel_mapping():
    """A flax ConvTranspose (k=2, s=2, 'SAME', transpose_kernel=False) with
    a non-symmetric kernel equals ``F.conv_transpose2d`` of the converted
    weight, and the unflipped kernel does not."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    kernel = rng.standard_normal((2, 2, 7, 3)).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    layer = fnn.ConvTranspose(3, (2, 2), strides=(2, 2))
    expected = np.asarray(layer.apply({'params': {'kernel': kernel, 'bias': bias}}, x))
    state = base.convert_params({'up/kernel': kernel, 'up/bias': bias}, {'up.weight'})
    got = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), state['up.weight'],
                             state['up.bias'], stride=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-6)
    unflipped = torch.from_numpy(kernel).permute(2, 3, 0, 1)
    wrong = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), unflipped,
                               state['up.bias'], stride=2).permute(0, 2, 3, 1).numpy()
    assert np.abs(wrong - expected).max() > 0.1
    back = base.flax_params([('up.weight', state['up.weight'])], {'up.weight'})
    np.testing.assert_array_equal(back['up/kernel'], kernel)


@pytest.mark.parametrize('snapshot', ['UNet_5', 'DNet_3x3_15x64f'])
def test_port_npz_is_read_by_the_reference(snapshot, tmp_path):
    """The port's save_model writes what the JAX package's load_model
    reads: changed weights, the same RGB within FWD_ATOL."""
    port = base.restore(SNAPSHOTS[snapshot], pipelines, patch_size=32, device='cpu')
    with torch.no_grad():
        for p in port.module.parameters():
            p.mul_(1.01)
    port.save_model(str(tmp_path), save_args=True)
    ref = jbase.restore(SNAPSHOTS[snapshot], jpipelines, patch_size=32)
    ref.load_model(str(tmp_path))
    x = raw_batch(21, n=1, p=32)
    np.testing.assert_allclose(np.asarray(ref.process(x)), port.process(x).numpy(),
                               atol=FWD_ATOL)


def test_snapshot_names_resolve_under_the_nip_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = pipelines.UNet(n_steps=2, device='cpu')
    model.save_model('Cam')
    assert os.path.isfile('data/models/nip/Cam/unet/unet.npz')
    other = pipelines.UNet(n_steps=2, device='cpu')
    with torch.no_grad():
        for p in other.module.parameters():
            p.zero_()
    other.load_model('Cam')
    for (k, a), (_, b) in zip(sorted(model.checkpoint().items()),
                              sorted(other.checkpoint().items())):
        np.testing.assert_array_equal(a, b, err_msg=k)
