"""Full-image development in row bands (``neural_imaging_tpu_torch/parallel/
spatial.py``, the port's ``develop_images --devices``) against the whole
padded stack developed at once and against the JAX package's spatially
sharded ``process`` on a ``('data', 'space')`` mesh of the CPU's virtual
devices, for the four shipped QualityRef NIPs, a narrow UNet and a
ClassicISP with the 'percentile' brightness, at 2 and 3 bands with heights
that the band count does not divide.

Tolerances: within 1e-5 of the whole padded stack's development (the
bands' convolutions sum in another order), within 1e-4 of JAX's."""
import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.sharding import Mesh

from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu.parallel.mesh import spatial_sharding
from neural_imaging_tpu_torch.models import base, pipelines
from neural_imaging_tpu_torch.parallel import spatial

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOTS = {'INet': 'INet_gbrg_5x5/inet', 'ClassicISP': 'ClassicISP_gbrg_5x5_-3R/classicisp',
             'DNet': 'DNet_3x3_15x64f/dnet', 'UNet': 'UNet_5/unet'}
# stack heights the band counts 2 and 3 leave a remainder of; UNet_5's padded
# height must fall on its grid of 16 rows
HEIGHTS = {'INet': 43, 'ClassicISP': 43, 'DNet': 41, 'UNet': 47}
WIDTH = 32
WHOLE_ATOL, JAX_ATOL = 1e-5, 1e-4


def stack_of(height, width, seed):
    return np.random.default_rng(seed).random((height, width, 4), dtype=np.float32)


def jax_spatially_sharded(model, padded, n):
    """The JAX CLI's --devices development of a padded stack: the image's
    height sharded over n devices of a ('data', 'space') mesh."""
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n), ('data', 'space'))
    batch = jax.device_put(padded[None], spatial_sharding(mesh))
    return np.asarray(model.process(batch))[0]


@pytest.fixture(scope='module')
def nips():
    out = {}
    for name, path in SNAPSHOTS.items():
        directory = os.path.join(ROOT, 'data/models/nip/QualityRef', path)
        port = getattr(pipelines, name)(patch_size=None, device='cpu')
        port.load_model(directory, quiet=True)
        ref = getattr(jpipelines, name)(patch_size=None)
        ref.load_model(directory, quiet=True)
        out[name] = port, ref
    return out


def assert_bands_match(port, ref, stack, n):
    padded = spatial.pad_rows(stack, n)
    assert padded.shape[0] % n == 0 and (stack.shape[0] % n == 0) == (padded is stack)
    bands = spatial.develop_bands(port, padded, ['cpu'] * n)
    whole = port.process(padded[None])[0]
    assert float((bands - whole).abs().max()) <= WHOLE_ATOL
    assert np.abs(bands.numpy() - jax_spatially_sharded(ref, padded, n)).max() <= JAX_ATOL
    image = spatial.develop_image(port, stack, ['cpu'] * n)
    assert image.shape == (2 * stack.shape[0], 2 * stack.shape[1], 3)
    assert torch.equal(image, bands[:2 * stack.shape[0]])


@pytest.mark.parametrize('n', [2, 3])
@pytest.mark.parametrize('name', sorted(SNAPSHOTS))
def test_bands_of_a_shipped_nip_match_the_whole_image_and_jax(nips, name, n):
    port, ref = nips[name]
    assert HEIGHTS[name] % n
    assert_bands_match(port, ref, stack_of(HEIGHTS[name], WIDTH, seed=n), n)


@pytest.mark.parametrize('n', [2, 3])
@pytest.mark.parametrize('brightness', ['percentile', 'shift'])
def test_bands_of_a_classic_isp_take_the_whole_image_brightness(brightness, n):
    """The brightness statistic is the whole (padded) image's, not a band's."""
    ref = jpipelines.ClassicISP(patch_size=None, c_filters=(4,), brightness=brightness)
    rng = np.random.default_rng(5)
    flat = {k: (np.asarray(v) + 0.05 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in traverse_util.flatten_dict(ref.params, sep='/').items()}
    ref.params = traverse_util.unflatten_dict({k: jax.numpy.asarray(v) for k, v in flat.items()},
                                              sep='/')
    port = pipelines.ClassicISP(patch_size=None, c_filters=(4,), brightness=brightness,
                                device='cpu')
    port.module.load_state_dict(base.convert_params(flat), strict=False)
    stack = stack_of(43, WIDTH, seed=11)
    assert_bands_match(port, ref, stack, n)
    # each band normalized by its own statistic would differ from the whole image's
    padded = spatial.pad_rows(stack, n)
    plan = spatial.plan_bands(padded.shape[0], n)
    own = torch.cat([port.process(padded[b.start:b.stop][None])[0] for b in plan])
    assert float((own - port.process(padded[None])[0]).abs().max()) > 1e-3


@pytest.mark.parametrize('n', [2, 3])
def test_bands_of_a_narrow_unet_are_real_bands(n):
    """A 2-level UNet (a halo of 12 rows on a grid of 2): the windows cover
    part of the image only, and the result is still the whole image's."""
    ref = jpipelines.UNet(patch_size=None, n_steps=2)
    port = pipelines.UNet(patch_size=None, n_steps=2, device='cpu')
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(ref.params, sep='/').items()}
    port.module.load_state_dict(base.convert_params(flat, base.transposed_kernels(port.module)),
                                strict=True)
    assert spatial.receptive_rows(port) == (12, 2)
    stack = stack_of(77, 16, seed=n)
    padded = spatial.pad_rows(stack, n)
    plan = spatial.plan_bands(padded.shape[0], n, *spatial.receptive_rows(port))
    assert all(b.hi - b.lo < padded.shape[0] for b in plan)
    assert all(b.start % 2 == 0 and b.lo % 2 == 0 for b in plan)
    assert_bands_match(port, ref, stack, n)


def test_unet5_bands_at_a_tall_image_match_the_whole(nips):
    """UNet_5 (a halo of 128 rows on its grid of 16) on 671 rows in 2 and 3
    bands whose windows do not cover the image."""
    port, _ = nips['UNet']
    stack = stack_of(671, 16, seed=3)
    for n in (2, 3):
        padded = spatial.pad_rows(stack, n)
        report = []
        bands = spatial.develop_bands(port, padded, ['cpu'] * n, report)
        assert all(r['window'][1] - r['window'][0] < padded.shape[0] for r in report)
        assert float((bands - port.process(padded[None])[0]).abs().max()) <= WHOLE_ATOL


def test_bands_without_a_halo_differ(nips, monkeypatch):
    """The halo is what makes the bands exact: without it, DNet's bands
    differ from the whole image near their edges."""
    port, _ = nips['DNet']
    stack = stack_of(40, WIDTH, seed=9)
    whole = port.process(stack[None])[0]
    monkeypatch.setattr(spatial, 'receptive_rows', lambda model: (0, 1))
    assert float((spatial.develop_bands(port, stack, ['cpu'] * 2) - whole).abs().max()) > 1e-3


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match='grid of 16'):
        spatial.plan_bands(40, 2, 16, 16)
    with pytest.raises(ValueError, match='4 bands'):
        spatial.plan_bands(48, 4, 16, 16)
    assert spatial.plan_bands(10, 3, 2) == [spatial.Band(0, 3, 0, 5), spatial.Band(3, 7, 1, 9),
                                            spatial.Band(7, 10, 5, 10)]
