"""Data parallelism in the PyTorch port (``neural_imaging_tpu_torch/parallel``):
a step over 2 gloo ranks, each a CPU process holding half of the global
batch, against the JAX package's step over a 2-device CPU mesh
(``parallel.train.distribute_workflow`` / ``distribute_model`` and
``shard_batch_args``) and against the port's own step in one process at the
global batch; the sampler's rows; and the mesh, multihost and DataParallel
helpers.

All rank cases run in one launch of 2 processes (``parallel.launch.run``, a
60 s deadline), each with one CPU thread.

Tolerances:
- the port's 2 ranks against JAX's mesh step: ``compare_steps``' bounds
  (loss parts 1e-3 and gradient norms 3e-3, relative);
- the port's 2 ranks against its one process at the global batch: each
  gradient within 1e-5 of its largest |entry| (float32 sums in another
  order), the loss parts within 1e-6 relative; the ranks' parameters after
  an Adam step bit-identical;
- the split latent: the entropy within 1e-6 of the global batch's, and at
  least 0.5 bit from the mean of the halves' own entropies; dz and dcb within
  1e-5 of their largest |entry|;
- the sampler: bit for bit."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu.models import compression as jcompression
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu.ops import ops as jops
from neural_imaging_tpu.parallel import make_mesh
from neural_imaging_tpu.parallel import train as jtrain
from neural_imaging_tpu.workflows import ManipulationClassification as JaxFlow
from neural_imaging_tpu_torch.models import base
from neural_imaging_tpu_torch.ops import quantization
from neural_imaging_tpu_torch.parallel import launch, mesh as mesh_lib, multihost
from neural_imaging_tpu_torch.parallel import train as ptrain
from neural_imaging_tpu_torch.workflows.manipulation_classification import compare_steps

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'support'))
import chip_smoke  # noqa: E402
import torch_parallel_workers as workers  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_DIR = os.path.join(ROOT, 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000')
PATCH, BATCH = 16, 4
FAN_ARGS = {'n_convolutions': 2, 'n_filters': 8, 'n_dense': 0}
JOINT = {'manipulations': ['sharpen', 'jpeg'], 'fan_args': FAN_ARGS, 'trainable': {'nip'},
         'distribution': {'downsampling': 'pool:2', 'compression': 'jpeg',
                          'compression_params': {'quality': 50, 'codec': 'soft'}},
         'nip_args': {'conv_precision': 'highest'}, 'patch': PATCH,
         'lambda_nip': 0.1, 'lambda_dcn': 0.0}
GRAD_RTOL = 1e-5
DEADLINE_S = 60


def flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep='/').items()}


def unflat(values):
    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in values.items()}, sep='/')


def drawn_weights(reference, seed):
    """numpy-drawn weights for a narrow model, as flax paths."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(flat(reference).items()):
        if k.startswith('constrained'):
            w = v + 0.1 * rng.standard_normal(v.shape)
        elif k.endswith('kernel'):
            w = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        else:
            w = v + 0.01 * rng.standard_normal(v.shape)
        out[k] = w.astype(np.float32)
    return out


def to_port(tree, part_is_flax=()):
    """A JAX gradient tree ({part: params}) as {part: {port name: tensor}}."""
    return {part: ({k: torch.from_numpy(v) for k, v in flat(leaves).items()}
                   if part in part_is_flax else base.convert_params(flat(leaves)))
            for part, leaves in tree.items()}


# -- the JAX package's steps over a 2-device mesh ---------------------------------

@pytest.fixture(scope='module')
def mesh2():
    if len(jax.devices()) < 2:
        pytest.skip('needs 2 JAX devices')
    return make_mesh(2)


def joint_reference():
    ref = JaxFlow('INet', manipulations=JOINT['manipulations'],
                  distribution=JOINT['distribution'], fan_args=FAN_ARGS,
                  trainable=JOINT['trainable'], raw_patch_size=PATCH,
                  nip_args=JOINT['nip_args'])
    fan_flat = drawn_weights(ref.fan.params, 7)
    fan_flat = {k: (v if not k.endswith('bias') else 0.01 * np.sign(v)).astype(np.float32)
                for k, v in fan_flat.items()}
    ref.fan.params = unflat(fan_flat)
    ref.nip.load_model(os.path.join(RUN_DIR, 'models/inet'))
    ref.params = ref._collect_params()
    ref.opt_state = ref._tx.init(ref._train_partition(ref.params))
    return ref, fan_flat


def joint_mesh_step(ref, mesh, bx, by):
    jtrain.distribute_workflow(ref, mesh)
    x, y = (jops.normalize_batch(jnp.asarray(b)) for b in (bx, by))
    x, y = jtrain.shard_batch_args(mesh, x, y)
    q_luma, q_chroma = (jnp.asarray(q) for q in ref._channel_qtables())

    def loss_of(tparams, fparams, x, y):
        return ref._losses({**fparams, **tparams}, x, y, jax.random.PRNGKey(0), q_luma,
                           q_chroma, jnp.float32(JOINT['lambda_nip']),
                           jnp.float32(JOINT['lambda_dcn']))
    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        ref._train_partition(ref.params), ref._frozen_partition(ref.params), x, y)
    fan_input = jax.jit(lambda p, x: ref._forward(p, x, jax.random.PRNGKey(0), q_luma,
                                                  q_chroma)[2])(ref.params, x)
    return (float(loss), {k: float(v) for k, v in parts.items()}, to_port(grads),
            np.asarray(fan_input))


def dcn_reference(train_codebook):
    ref = jcompression.TwitterDCN(patch_size=32, n_features=4, train_codebook=train_codebook,
                                  use_pallas_quantization=True)
    values = flat(ref.params)
    if train_codebook:
        values['codebook'] = values['codebook'] + 0.05
    ref.params = unflat(values)
    return ref, values


def dcn_mesh_step(ref, mesh, x):
    jtrain.distribute_model(ref, mesh)
    (xs,) = jtrain.shard_batch_args(mesh, jnp.asarray(x))

    def loss_of(params, x):
        y, entropy = ref._apply(params, x)
        return ref.loss(x, y, entropy), entropy
    (loss, entropy), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(ref.params, xs)
    return (float(loss), {'entropy': float(entropy)},
            {'dcn': base.convert_params(flat(grads))})


def nip_reference():
    ref = jpipelines.ClassicISP(patch_size=PATCH, c_filters=(4,), brightness='percentile')
    values = drawn_weights(ref.params, 3)
    ref.params = unflat(values)
    return ref, values


def nip_mesh_step(ref, mesh, bx, by):
    jtrain.distribute_model(ref, mesh)
    x, y = jtrain.shard_batch_args(mesh, jnp.asarray(bx), jnp.asarray(by))

    def loss_of(params, x, y):
        return ref.loss(ref._apply(params, x), y)
    loss, grads = jax.jit(jax.value_and_grad(loss_of))(ref.params, x, y)
    return float(loss), {}, {'nip': base.convert_params(flat(grads))}


# -- the cases, on 2 ranks and in one process ------------------------------------

def camera_batches(seed):
    pairs = [fixtures.make_raw_rgb_pair(2 * PATCH, 2 * PATCH, seed=seed + i)
             for i in range(BATCH)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def rgb_images(seed, n, size):
    return np.stack([fixtures.procedural_image(size, size, seed=seed + i)
                     for i in range(n)]).astype(np.float32)


def split_latent(n=96):
    """A latent whose two halves sit by two codewords far apart: each half
    alone is nearly one codeword (entropy near 0), the whole two (near 1 bit)."""
    rng = np.random.default_rng(5)
    z = np.concatenate([-3.0 + 0.3 * rng.standard_normal(n), 5.0 + 0.3 * rng.standard_normal(n)])
    return z.astype(np.float32), rng.standard_normal(2 * n).astype(np.float32)


@pytest.fixture(scope='module')
def sampler_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('dp-data'))
    fixtures.make_dataset(d, n_images=8, height=64, width=64, seed=31)
    return d


@pytest.fixture(scope='module')
def cases(mesh2, sampler_dir):
    """Every case's spec, its references (JAX mesh steps) and its results on
    2 ranks and in one process."""
    joint_ref, fan_flat = joint_reference()
    bx, by = camera_batches(60)
    nip_ref, nip_flat = nip_reference()
    nx, ny = camera_batches(80)
    nx, ny = (b.astype(np.float32) / (65535.0 if b.dtype == np.uint16 else 255.0)
              for b in (nx, ny))
    x = rgb_images(90, BATCH, 32)
    z, w = split_latent()
    specs = [('joint', 'joint', {**JOINT, 'fan_flat': fan_flat, 'bx': bx, 'by': by,
                                 'nip_dir': os.path.join(RUN_DIR, 'models/inet')}),
             ('nip', 'nip', {'patch': PATCH, 'args': {'c_filters': (4,),
                                                     'brightness': 'percentile'},
                             'flat': nip_flat, 'bx': nx, 'by': ny}),
             ('sampler', 'sampler', {'data_dir': sampler_dir, 'load': 'xy', 'n_images': 6,
                                     'v_images': 2, 'patch': 32, 'batch': BATCH, 'steps': 3}),
             ('multihost', 'multihost', {'batch': 8}),
             ('inference', 'inference', {'x': camera_batches(70)[0][:3].astype(np.float32)
                                         / 65535.0})]
    refs = {'joint': joint_mesh_step(joint_ref, mesh2, bx, by),
            'nip': nip_mesh_step(nip_ref, mesh2, nx, ny)}
    for trainable in (False, True):
        name = f'dcn-{"trainable" if trainable else "fixed"}'
        dcn_ref, dcn_flat = dcn_reference(trainable)
        specs.append((name, 'dcn', {'patch': 32, 'args': {'n_features': 4,
                                                          'train_codebook': trainable},
                                    'flat': dcn_flat, 'x': x}))
        refs[name] = dcn_mesh_step(dcn_ref, mesh2, x)
        specs.append((f'split-{name}', 'quantizer', {
            'z': z, 'w': w, 'codebook': quantization.default_codebook(5).astype(np.float32),
            'trainable': trainable, 'lambda': 2.0}))
    ranks = launch.run(workers.run_cases, ['cpu', 'cpu'], args=(specs,), threads=1,
                       timeout_s=DEADLINE_S)
    single = workers.run_cases(None, specs)
    return {'refs': refs, 'ranks': ranks, 'single': single}


def assert_close_grads(got, ref, rtol=GRAD_RTOL):
    assert got.keys() == ref.keys()
    for k in ref:
        scale = float(ref[k].abs().max())
        err = float((got[k] - ref[k]).abs().max())
        assert err <= rtol * max(scale, 1e-30), (k, err, scale)


def assert_identical_ranks(ranks, key='params'):
    a, b = ranks[0][key], ranks[1][key]
    flat_a = {f'{p}/{k}': v for p, leaves in a.items() for k, v in leaves.items()} \
        if isinstance(next(iter(a.values())), dict) else a
    flat_b = {f'{p}/{k}': v for p, leaves in b.items() for k, v in leaves.items()} \
        if isinstance(next(iter(b.values())), dict) else b
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert torch.equal(flat_a[k], flat_b[k]), k


def test_joint_step_matches_the_jax_mesh_step(cases):
    """The joint step (INet → sharpen, jpeg → pool → JPEG q50 through K1's
    plain version → FAN, the NIP trainable) over 2 ranks: JAX's mesh step
    within compare_steps (the FAN's leaves within chip_smoke.py's flipped
    bound where a dJPEG coefficient of the FAN's input rounds the other way
    in the two packages, counted as chip_smoke.py counts them), the
    one-process step at the global batch within 1e-5 of each gradient's
    scale, and identical ranks after the update."""
    ranks, single = cases['ranks'], cases['single']['joint']
    *ref_step, ref_fan_input = cases['refs']['joint']
    flips = int((np.abs(single['fan_input'] - ref_fan_input) > chip_smoke.FLIP_THRESHOLD).sum())
    for r in ranks:
        # a flipped dJPEG coefficient holds the FAN's leaves to the flipped bound
        chip_smoke.compare_flow_steps(r['joint']['step'], ref_step, flips)
    loss, parts, grads = ranks[0]['joint']['step']
    s_loss, s_parts, s_grads = single['step']
    np.testing.assert_allclose(float(loss), float(s_loss), rtol=1e-6)
    for k in s_parts:
        np.testing.assert_allclose(float(parts[k]), float(s_parts[k]), rtol=1e-6, atol=1e-9)
    for part in s_grads:
        assert_close_grads(grads[part], s_grads[part])
    assert_identical_ranks([r['joint'] for r in ranks])


@pytest.mark.parametrize('kind', ['fixed', 'trainable'])
def test_dcn_step_matches_the_jax_mesh_step(cases, kind):
    """The DCN step (TwitterDCN, 4 features, 4 x 32², the entropy from K2's,
    K3's or K4's plain versions) over 2 ranks: the global latent's entropy,
    JAX's mesh step (its Pallas VJP) within compare_steps, the one-process
    step's gradients within 1e-5 of their scale, identical ranks."""
    name = f'dcn-{kind}'
    ranks, single = cases['ranks'], cases['single'][name]
    ref_loss, ref_parts, ref_grads = cases['refs'][name]
    for r in ranks:
        v = r[name]['values']
        step = (float(v['loss']) ** 2 / 2, {'entropy': float(v['entropy'])},
                {'dcn': r[name]['grads']})
        compare_steps(step, (ref_loss, ref_parts, ref_grads))
        assert abs(float(v['entropy']) - float(single['values']['entropy'])) < 1e-6
    assert ('codebook' in ref_grads['dcn']) == (kind == 'trainable')
    assert_close_grads(ranks[0][name]['grads'], single['grads'])
    np.testing.assert_allclose(float(ranks[0][name]['values']['loss']),
                               float(single['values']['loss']), rtol=1e-6)
    assert_identical_ranks([r[name] for r in ranks])


@pytest.mark.parametrize('kind', ['fixed', 'trainable'])
def test_split_latent_entropy_is_the_global_one(cases, kind):
    """Halves of a latent that fall on different codewords, one a rank: the
    ranks' entropy and gradients are the global batch's, and the mean of the
    halves' own entropies (what a rank would see alone) is far from it."""
    name = f'split-dcn-{kind}'
    single = cases['single'][name]
    for r in cases['ranks']:
        got = r[name]
        assert abs(float(got['entropy']) - float(single['entropy'])) < 1e-6
        local_mean = np.mean([float(q[name]['local_entropy']) for q in cases['ranks']])
        assert abs(float(got['entropy']) - local_mean) > 0.5, (float(got['entropy']),
                                                               local_mean)
        for key in ('dz', 'dcb'):
            scale = float(single[key].abs().max())
            assert float((got[key] - single[key]).abs().max()) <= GRAD_RTOL * max(scale, 1e-30)
    if kind == 'trainable':
        assert float(single['dcb'].abs().max()) > 0


def test_percentile_classic_isp_step_matches_the_jax_mesh_step(cases):
    """A ClassicISP with brightness='percentile' over 2 ranks: the percentile
    of the global batch (gathered in its NHWC order), JAX's mesh step within
    compare_steps, the one-process step within 1e-5, identical ranks."""
    ranks, single = cases['ranks'], cases['single']['nip']
    for r in ranks:
        compare_steps((r['nip']['loss'], {}, {'nip': r['nip']['grads']}), cases['refs']['nip'])
    np.testing.assert_allclose(float(ranks[0]['nip']['loss']), float(single['loss']),
                               rtol=1e-6)
    assert_close_grads(ranks[0]['nip']['grads'], single['grads'])
    assert_identical_ranks([r['nip'] for r in ranks])


def test_sampler_rows_concatenate_to_the_one_process_batch(cases):
    single = cases['single']['sampler']
    for step, batch in enumerate(single):
        for i, t in enumerate(batch):
            joined = torch.cat([r['sampler'][step][i] for r in cases['ranks']])
            assert torch.equal(joined, t), (step, i)


def test_multihost_helpers_over_two_processes(cases):
    got = [r['multihost'] for r in cases['ranks']]
    assert [g['rank'] for g in got] == [0, 1] and all(g['count'] == 2 for g in got)
    assert [g['primary'] for g in got] == [True, False]
    assert [g['write'] for g in got] == ['written', None]
    assert [g['slice'] for g in got] == [(0, 4), (4, 4)]
    assert all(g['mean'] == 0.5 and g['agreed'] == 'rank 0' and g['mesh'] == 2 for g in got)
    assert cases['single']['multihost']['slice'] == (0, 8)


def test_sharded_inference_pads_and_gathers_the_whole_batch(cases):
    """3 images over 2 ranks: padded to 4, each rank develops 2, every rank
    gets the 3 developed images back."""
    single = cases['single']['inference']
    for r in cases['ranks']:
        assert r['inference'].shape == single.shape == (3, 2 * PATCH, 2 * PATCH, 3)
        assert float((r['inference'] - single).abs().max()) <= 1e-6


# -- the helpers, in one process ---------------------------------------------------

def test_from_spec_shrinks_to_a_divisor(caplog):
    assert ptrain.resolve_count(4, batch_size=6, device='cpu') == 3
    assert 'does not divide' in caplog.text
    assert ptrain.resolve_count('auto', batch_size=6, device='cpu') == 1
    assert ptrain.resolve_count(None) == ptrain.resolve_count('none') == 1
    for spec in (None, 'none', '', 1, 'auto'):
        assert ptrain.DataParallel.from_spec(spec, batch_size=6, device='cpu') is None
    assert ptrain.DataParallel.from_spec(4, batch_size=5, device='cpu') is None
    with pytest.raises(ValueError, match='this process is one of 1'):
        ptrain.DataParallel.from_spec(2, batch_size=6, device='cpu')


def test_device_counts_refuse_more_cards_than_the_machine_has():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f'--devices {n + 1} asks for {n + 1} CUDA'):
        ptrain.count_devices(n + 1, 'cuda')
    with pytest.raises(ValueError, match=f'this machine has {n}'):
        launch.rank_devices('cuda', n + 1)
    assert launch.rank_devices('cpu', 3) == ['cpu'] * 3


def test_check_batch_and_shard():
    dp = ptrain.DataParallel(mesh_lib.Mesh('cpu', world_size=2, rank=1))
    dp.check_batch(4)
    with pytest.raises(ValueError, match='must divide across the 2'):
        dp.check_batch(5)
    x = np.arange(12).reshape(6, 2)
    (part,) = dp.shard(x)
    np.testing.assert_array_equal(part, x[3:])
    assert mesh_lib.local_batch_slice(6, dp.mesh) == (3, 3)
    with pytest.raises(ValueError):
        mesh_lib.local_batch_slice(5, dp.mesh)
    assert 'rank' in repr(dp.mesh) and dp.describe().startswith('data-parallel over 2')


@pytest.mark.parametrize('as_tensor', [False, True])
def test_pad_batch_to_devices(as_tensor):
    mesh = mesh_lib.Mesh('cpu', world_size=4)
    batch = np.random.default_rng(0).random((13, 4, 4, 3)).astype(np.float32)
    if as_tensor:
        batch = torch.from_numpy(batch)
    padded, orig = ptrain.pad_batch_to_devices(batch, mesh)
    assert padded.shape[0] == 16 and orig == 13
    assert all(np.array_equal(np.asarray(padded[i]), np.asarray(batch[-1])) for i in (13, 15))
    same, n = ptrain.pad_batch_to_devices(batch[:12], mesh)
    assert same.shape[0] == n == 12


def test_multihost_single_process_no_ops():
    assert multihost.initialize(device='cpu') is False
    assert multihost.is_primary() and multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert multihost.local_batch_slice(8) == (0, 8)
    assert multihost.sync_global_value(0.5) == 0.5
    marker = object()
    assert multihost.agree(marker) is marker
    assert multihost.global_mesh('cpu').world_size == 1
    with pytest.raises(ValueError, match='missing --nproc, --procid'):
        multihost.initialize('127.0.0.1:1234', device='cpu')


def test_primary_only():
    calls = []

    @multihost.primary_only
    def write(x):
        calls.append(x)
        return x
    assert write(3) == 3 and calls == [3]
