"""The plain reference against the port, layer by layer, at a tiny size on
the CPU (the port on its kernels' plain versions): a check of the oracle
itself. On the card the harness holds the port to it at the cells' sizes."""
import json

import numpy as np
import pytest
import torch

from benchmark import generator, run, system
from benchmark.entries.training_step import reference_leaves
from benchmark.reference import dcn, fan, isp, isp_inet, jpeg, manipulations
from benchmark.reference.joint_flow import JointFlow

TOL = 1e-5


def build(config_name, raw_patch=16):
    config = json.loads((run.BENCH / 'configs' / f'{config_name}.json').read_text())
    config['flow']['raw_patch_size'] = raw_patch
    torch.manual_seed(0)
    flow, handed = system.build(config, 3, torch.device('cpu'))
    ref = JointFlow(config, reference_leaves(config, handed, torch.device('cpu')))
    return config, flow, ref


def rgb(n, side, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return generator.smooth_rgb(gen, n, side, 8, 0.02, 'cpu')


def close(a, b, tol=TOL):
    a, b = torch.as_tensor(a).detach().double(), torch.as_tensor(b).detach().double()
    assert a.shape == b.shape
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


@pytest.fixture(scope='module')
def m_quality():
    return build('m_quality')


def test_isp_agrees(m_quality):
    _, flow, ref = m_quality
    x = isp.mosaic(rgb(2, 32) ** 2.2)
    y = flow.nip.process(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert close(y, isp_inet.develop(x, ref.part('nip')))


def test_manipulations_agree(m_quality):
    config, flow, _ = m_quality
    y = rgb(2, 32)
    ours = manipulations.expand(y, config['flow']['manipulations'])
    theirs = flow.run_manipulations(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert close(theirs, ours, 1e-4)


@pytest.mark.parametrize('quality', [50, 80])
def test_jpeg_agrees(quality):
    from neural_imaging_tpu_torch.models import jpeg as port_jpeg
    y = rgb(2, 32)
    q_luma, q_chroma = port_jpeg.qtables(quality, 'cpu')
    assert np.array_equal(q_luma.numpy(), jpeg.qtable(quality, True))
    assert np.array_equal(q_chroma.numpy(), jpeg.qtable(quality, False))
    theirs = port_jpeg.jpeg_forward_nchw(y, q_luma, q_chroma)[0]
    assert close(theirs, jpeg.jpeg(y, quality)[0], 1e-4)


def test_fan_agrees(m_quality):
    config, flow, ref = m_quality
    c = rgb(3, 32)
    probs = flow.fan.module(c)
    assert close(probs, fan.fan(c, ref.part('fan'), **config['flow']['fan_args']))


def test_codec_agrees():
    config, flow, ref = build('m_quality_dcn')
    c = rgb(2, 32)
    with torch.no_grad():
        decoded, entropy = flow.codec._apply(c)
        latent = flow.codec.module.encoder(c) * flow.codec.module.latent_scale
    ours = dcn.codec(c, ref.part('dcn'), config['codec']['latent_bpf'])
    q_ref = ours[2]
    assert close(flow.codec.compress(c.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), q_ref)
    assert close(decoded, ours[0])
    assert abs(float(entropy) - float(ours[1])) <= 1e-4 * float(ours[1])
    cb = torch.as_tensor(dcn.codebook(5))
    assert torch.equal(dcn.quantize(latent, cb)[2], (latent[..., None] - cb).abs().argmin(-1))


def test_handed_codewords_and_their_gap():
    cb = torch.as_tensor(dcn.codebook(5))
    z = torch.tensor([[0.2, 1.4999, -3.7], [15.9, 2.5001, -20.0]])
    q, entropy, index, gap = dcn.quantize(z, cb)
    assert gap == (0.0, 0)
    same = dcn.quantize(z, cb, index=index)
    assert torch.equal(same[0], q) and float(same[1]) == float(entropy) and same[3] == (0.0, 0)
    # the near-tie taken the other way: twice its distance from the midpoint
    other = index.clone()
    other[0, 1] += 1
    q2, _, index2, gap2 = dcn.quantize(z, cb, index=other)
    assert torch.equal(index2, other) and float(q2[0, 1]) == float(cb[other[0, 1]])
    assert gap2[1] == 1 and abs(gap2[0] - 2e-4) < 1e-5
    # a value put on a codeword two away
    other[1, 0] -= 2
    assert dcn.quantize(z, cb, index=other)[3][1] == 2
    assert abs(dcn.quantize(z, cb, index=other)[3][0] - 1.8) < 1e-4
    # codewords of another shape are not the latent's: the reference keeps its own
    q3, _, index3, gap3 = dcn.quantize(z, cb, index=index[:1])
    assert torch.equal(index3, index) and gap3[0] == float('inf')


def test_the_whole_flow_agrees(m_quality):
    config, flow, ref = m_quality
    x = isp.mosaic(rgb(2, 32, seed=4) ** 2.2)
    theirs = flow.run_workflow(x.permute(0, 2, 3, 1))
    ours = ref.forward(x)
    assert close(theirs[-1], ours['probs'], 1e-4)
    assert close(theirs[2].permute(0, 3, 1, 2), ours['C'], 1e-4)
