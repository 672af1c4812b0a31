"""The model shell's helpers, the FAN's own training step and the Bayer
helpers against the JAX package, on the CPU, at narrow widths with the JAX
model's weights carried into the port.

- ``deploy_model``: the exported program, reloaded with
  ``torch.export.load``, gives the model's own ``serve`` exactly (the same
  operators on the same inputs) and the JAX ``_apply`` within 1e-5 (float32
  convolutions in another summation order); the manifest has the
  reference's keys.
- ``count_parameters_breakdown``: the JAX DataFrame's rows exactly.
- ``migrate_model``: one mapping on one npz gives both packages the same
  weights, exactly.
- The FAN's dropout step: the masks flax draws are recorded (under
  ``jax.disable_jit``, by wrapping ``jax.random.bernoulli`` in this test) and
  passed to the port; loss and parameters after one Adam step within 1e-5.
- ``simulate_bayer`` and ``rgb_to_raw_stack`` bit for bit."""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.data import bayer as jbayer
from neural_imaging_tpu.data import raw as jraw
from neural_imaging_tpu.models import compression as jcompression
from neural_imaging_tpu.models import forensics as jforensics
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu_torch.data import bayer, raw
from neural_imaging_tpu_torch.models import compression, forensics, pipelines
from neural_imaging_tpu_torch.models.base import convert_params, transposed_kernels
from neural_imaging_tpu_torch.ops.hopper import codebook
from neural_imaging_tpu_torch.utils.table import Table

torch.set_num_threads(1)

MAX_JAX_DIFF = 1e-5

FAN_ARGS = dict(n_classes=3, patch_size=16, n_convolutions=2, n_filters=8, n_dense=1,
                use_gap=True)
MODELS = {
    'INet': (lambda: jpipelines.INet(patch_size=16),
             lambda: pipelines.INet(patch_size=16, device='cpu'), 4, 16),
    'UNet': (lambda: jpipelines.UNet(n_steps=2, patch_size=16),
             lambda: pipelines.UNet(n_steps=2, patch_size=16, device='cpu'), 4, 16),
    'FAN': (lambda: jforensics.FAN(**FAN_ARGS),
            lambda: forensics.FAN(**FAN_ARGS, device='cpu'), 3, 16),
    'TwitterDCN': (lambda: jcompression.TwitterDCN(n_features=8, patch_size=32),
                   lambda: compression.TwitterDCN(n_features=8, patch_size=32, device='cpu'),
                   3, 32),
}


def flat_params(jax_model):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax_model.params, sep='/').items()}


@functools.lru_cache()
def reference(name):
    """The JAX model, made once for the tests that leave it as it is."""
    return MODELS[name][0]()


def pair(name, fresh=False):
    make_jax, make_port, channels, patch = MODELS[name]
    jax_model, port = make_jax() if fresh else reference(name), make_port()
    port.module.load_state_dict(convert_params(flat_params(jax_model),
                                               transposed_kernels(port.module)))
    return jax_model, port, channels, patch


def as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_deployed_program_reloads_and_serves_the_model(name, tmp_path):
    jax_model, port, channels, patch = pair(name)
    out_dir = port.deploy_model(str(tmp_path / 'serve'), batch_size=2)
    program = torch.export.load(os.path.join(out_dir, 'model.pt2')).module()
    x = np.random.default_rng(7).random((2, patch, patch, channels)).astype(np.float32)
    with torch.no_grad():
        got = as_tuple(program(torch.from_numpy(x)))
        want = as_tuple(port.serve(torch.from_numpy(x)))
    ref = as_tuple(jax_model._apply(jax_model.params, x))
    assert len(got) == len(want) == len(ref)
    for a, b, r in zip(got, want, ref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=MAX_JAX_DIFF)
    with open(os.path.join(out_dir, 'manifest.json')) as f:
        manifest = json.load(f)
    jax_dir = jax_model.deploy_model(str(tmp_path / 'jax_serve'), batch_size=2)
    with open(os.path.join(jax_dir, 'manifest.json')) as f:
        reference = json.load(f)
    assert sorted(manifest) == sorted(reference)
    assert manifest['input_shape'] == reference['input_shape'] == [2, patch, patch, channels]
    assert manifest['model'] == reference['model']
    assert manifest['format'] == 'torch.export + npz weights'
    stem = port.class_name.lower()
    npz = os.path.join(out_dir, f'{stem}.npz')
    npz = npz if os.path.isfile(npz) else os.path.join(out_dir, port.scoped_name, f'{stem}.npz')
    with np.load(npz) as z:
        assert sorted(z.files) == sorted(flat_params(jax_model))


def test_deployed_dcn_traces_the_plain_quantizer_on_the_cpu(tmp_path):
    """On the CPU no kernel operator is in the program: K2's plain version is."""
    _, port, _, _ = pair('TwitterDCN')
    port.deploy_model(str(tmp_path / 'dcn'))
    program = torch.export.load(str(tmp_path / 'dcn' / 'model.pt2'))
    assert not any('neural_imaging_tpu_torch' in str(n.target) for n in program.graph.nodes)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_parameter_breakdown_is_the_reference_frame(name):
    jax_model, port, _, _ = pair(name)
    table = port.count_parameters_breakdown()
    frame = jax_model.count_parameters_breakdown()
    assert isinstance(table, Table)
    assert table.columns == list(frame.columns)
    assert [list(row.values()) for row in table.rows] == frame.values.tolist()
    assert port.count_parameters() == jax_model.count_parameters()


def renamed_checkpoint(jax_model, directory):
    """The JAX model's weights saved under 'old_' names, and the {'new':
    'old'} mapping back, with one parameter left unmapped."""
    flat = flat_params(jax_model)
    names = list(flat)
    path = os.path.join(directory, jax_model.scoped_name)
    os.makedirs(path)
    np.savez(os.path.join(path, f'{jax_model.class_name.lower()}.npz'),
             **{f'old_{k}': v * 1.5 for k, v in flat.items()})
    return {k: f'old_{k}' for k in names[:-1]}, names[-1]


@pytest.mark.parametrize('name', ['UNet', 'FAN'])
def test_migrate_model_maps_the_same_weights(name, tmp_path):
    jax_model, port, _, _ = pair(name, fresh=True)
    before = flat_params(jax_model)
    mapping, unmapped = renamed_checkpoint(jax_model, str(tmp_path))
    jax_model.migrate_model(str(tmp_path), mapping)
    port.migrate_model(str(tmp_path), mapping)
    after, got = flat_params(jax_model), port.checkpoint()
    assert sorted(got) == sorted(after)
    for k in after:
        np.testing.assert_array_equal(got[k], after[k])
    np.testing.assert_array_equal(got[unmapped], before[unmapped])
    assert not np.array_equal(got[next(iter(mapping))], before[next(iter(mapping))])


def test_migrate_model_refuses_a_shape_mismatch(tmp_path):
    jax_model, port, _, _ = pair('INet', fresh=True)
    mapping, _ = renamed_checkpoint(jax_model, str(tmp_path))
    first, second = list(mapping)[:2]
    swapped = {**mapping, first: mapping[second], second: mapping[first]}
    with pytest.raises(ValueError, match='shape mismatch'):
        jax_model.migrate_model(str(tmp_path), swapped)
    with pytest.raises(ValueError, match='shape mismatch'):
        port.migrate_model(str(tmp_path), swapped)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_show_model_tabulates_the_module_tree(name):
    _, port, channels, patch = pair(name)
    table = port.show_model(batch_size=2)
    assert table.columns == ['module', 'type', 'output shape', 'parameters']
    core = table.rows[-1]
    assert core['module'] == type(port.module).__name__
    assert core['parameters'] == port.count_parameters()
    with torch.no_grad():
        out = as_tuple(port.serve(torch.zeros(2, patch, patch, channels)))
    shapes = [tuple(o.shape) for o in out]
    assert core['output shape'] == (shapes[0] if len(shapes) == 1 else tuple(shapes))
    named = [name for name, _ in port.module.named_modules() if name]
    assert set(table['module'][:-1]) <= set(named)
    assert 'output shape' in table.to_string()


def record_flax_masks():
    masks = []
    original = jax.random.bernoulli

    def spy(*args, **kwargs):
        mask = original(*args, **kwargs)
        masks.append(np.asarray(mask))
        return mask
    return masks, original, spy


@pytest.mark.parametrize('n_dense', [1, 2])
def test_fan_dropout_step_matches_flax_with_its_masks(n_dense, monkeypatch):
    args = {**FAN_ARGS, 'n_dense': n_dense, 'dropout': 0.3}
    jax_model = jforensics.FAN(**args)
    port = forensics.FAN(**args, device='cpu')
    port.module.load_state_dict(convert_params(flat_params(jax_model),
                                               transposed_kernels(port.module)))
    x = np.random.default_rng(3).random((4, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 0])
    masks, _, spy = record_flax_masks()
    monkeypatch.setattr(jax.random, 'bernoulli', spy)
    with jax.disable_jit():
        loss_ref = float(jax_model.training_step(x, labels, 1e-3))
    monkeypatch.undo()
    assert [m.shape for m in masks] == port.module.dropout_shapes(4)
    assert 0 < np.mean(np.concatenate([m.ravel() for m in masks])) < 1
    loss = float(port.training_step(x, labels, 1e-3, dropout_mask=masks))
    assert abs(loss - loss_ref) <= MAX_JAX_DIFF
    after, got = flat_params(jax_model), port.checkpoint()
    for k in after:
        np.testing.assert_allclose(got[k], after[k], rtol=0, atol=MAX_JAX_DIFF)


def test_fan_dropout_step_draws_its_own_masks():
    """Without masks the FAN draws fresh ones from its seeded generator:
    two FANs give the same steps, and a step differs from the no-dropout one."""
    args = {**FAN_ARGS, 'n_dense': 2, 'dropout': 0.5}
    x = np.random.default_rng(4).random((4, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 0])
    a, b = forensics.FAN(**args, device='cpu'), forensics.FAN(**args, device='cpu')
    steps_a = [float(a.training_step(x, labels, 1e-3)) for _ in range(2)]
    steps_b = [float(b.training_step(x, labels, 1e-3)) for _ in range(2)]
    assert steps_a == steps_b and all(np.isfinite(steps_a))
    plain = forensics.FAN(**{**args, 'dropout': 0.0}, device='cpu')
    assert float(plain.training_step(x, labels, 1e-3)) != steps_a[0]
    # the classifier's forward (as the joint step calls it) has no dropout
    with torch.no_grad():
        p1 = a.process(x)
        p2 = a.process(x)
    assert torch.equal(p1, p2)


@pytest.mark.parametrize('cfa', sorted(bayer.CFA_OFFSETS))
def test_bayer_helpers_are_bit_identical(cfa):
    rgb = np.random.default_rng(5).random((3, 8, 12, 3))
    np.testing.assert_array_equal(bayer.simulate_bayer(rgb, cfa), jbayer.simulate_bayer(rgb, cfa))
    np.testing.assert_array_equal(raw.simulate_bayer(rgb[0], cfa),
                                  jraw.simulate_bayer(rgb[0], cfa))
    for dtype in (np.uint16, np.float32):
        got = bayer.rgb_to_raw_stack(rgb[0] * 1.2 - 0.1, cfa, dtype=dtype)
        want = jbayer.rgb_to_raw_stack(rgb[0] * 1.2 - 0.1, cfa, dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        bayer.simulate_bayer(rgb[0, 0], cfa)


def test_fixed_size_codeword_counts_equal_bincount():
    """The entropy's counts (a fixed-size index_add_, which torch.export
    takes) equal torch.bincount's, bit for bit."""
    z = torch.from_numpy(np.random.default_rng(6).standard_normal(5000).astype(np.float32) * 6)
    cb = torch.linspace(-15, 16, 32)
    _, hard = codebook.codebook_fwd(z, cb)
    _, _, _, counts, _, _, _ = codebook._forward(z, cb, 50.0, 25.0)
    want = torch.bincount(hard, minlength=32).to(torch.float32)
    assert torch.equal(counts, want)
