"""A configuration's parts found by name from files: the reference ISP, any
manipulation outside the table, the reference flow, and the parts whose
weights are drawn from the seed, on the CPU at the tiny sizes."""
import json
import sys

import pytest
import torch
from conftest import TINY

from benchmark import run, system
from benchmark.reference import by_name, manipulations

MANIFEST = json.loads((run.ROOT / 'BENCHMARK.json').read_text())
CONFIGS = [c['name'] for c in MANIFEST['configs']]
SEED = 2 ** 31 + 13
DRAWN_ISP = {'weights': {'nip': system.DRAWN}, 'flow': {'nip_snapshot': None}}


def config_of(name):
    return json.loads((run.BENCH / 'configs' / f'{name}.json').read_text())


@pytest.mark.parametrize('name', CONFIGS)
def test_every_configuration_resolves_to_files(name):
    config = config_of(name)
    flow = by_name.flow(config)
    assert callable(flow.Flow)
    parts = flow.parts(config)
    assert hasattr(parts['nip'][0], 'develop')
    for spec in config['flow']['manipulations']:
        assert callable(manipulations.function(spec.split(':')[0]))
    for part, weights in config['weights'].items():
        module = parts[part][0]
        if weights == system.DRAWN:
            assert callable(module.leaf_shapes)
        else:
            assert callable(module.load) and (system.REPO / weights).is_file()


@pytest.mark.parametrize('cell', ['m_quality-train', 'm_quality-classify'])
def test_a_drawn_isp_is_handed_to_both_sides_and_correct(cell):
    """INet drawn from the seed (no snapshot): the program holds the draws,
    the reference is handed them, and the dry run comes out correct."""
    held = {}

    def keep_isp(flow):
        held.update({k: p.detach().clone() for k, p in flow.nip.module.named_parameters()})
    overrides = run.merge(TINY, {'config': DRAWN_ISP})
    torch.manual_seed(0)
    r = run.run(cell, SEED, 0.2, 0, 'cpu', overrides=overrides, tamper=keep_isp)
    assert r['correct'] is True, r['checks']
    config = run.merge(run.cell(cell, MANIFEST)[3], overrides['config'])
    drawn = system.drawn_leaves(config, SEED, torch.device('cpu'))
    nip = {k[len('nip/'):]: v for k, v in drawn.items() if k.startswith('nip/')}
    assert sorted(nip) == sorted(held)
    assert all(torch.equal(held[k], v) for k, v in nip.items())
    # the draws, not the snapshot's leaves
    snapshot = system.snapshot_leaves(config_of('m_quality'), torch.device('cpu'))
    assert not torch.equal(nip['demosaic'], snapshot['nip/demosaic'])


def test_each_drawn_part_has_a_generator_of_its_own():
    assert system.part_seed('fan', SEED) == SEED
    seeds = {system.part_seed(p, SEED) for p in ('fan', 'nip', 'dcn')}
    assert len(seeds) == 3 and all(0 <= s < 2 ** 64 for s in seeds)
    config = run.merge(config_of('m_quality'), DRAWN_ISP)
    drawn = system.drawn_leaves(config, SEED, torch.device('cpu'))
    fan_alone = system.drawn_leaves(config_of('m_quality'), SEED, torch.device('cpu'))
    assert all(torch.equal(drawn[k], v) for k, v in fan_alone.items())


@pytest.mark.parametrize('override,missing', [
    ({'flow': {'nip': 'NoSuchISP'}}, 'benchmark/reference/isp_nosuchisp.py'),
    ({'flow': {'manipulations': ['sharpen:1', 'nosuch:1']}},
     'benchmark/reference/manipulation_nosuch.py'),
    ({'reference': 'no_such_flow'}, 'benchmark/reference/no_such_flow.py')])
def test_a_name_without_its_file_fails_at_set_up(override, missing):
    overrides = run.merge(TINY, {'config': override})
    with pytest.raises(FileNotFoundError, match=missing):
        run.run('m_quality-train', SEED, 0.2, 0, 'cpu', overrides=overrides)


def test_a_manipulation_outside_the_table_is_found_by_file(tmp_path, monkeypatch):
    package = tmp_path / 'benchmark' / 'reference'
    package.mkdir(parents=True)
    (package / 'manipulation_invert.py').write_text(
        'def apply(y, strength):\n    return strength - y\n')
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        y = torch.rand(2, 3, 8, 8)
        out = manipulations.expand(y, ['sharpen:1', 'invert:1'])
        assert torch.equal(out[:2], y) and torch.equal(out[4:], 1 - y)
    finally:
        sys.modules.pop('benchmark.reference.manipulation_invert', None)
