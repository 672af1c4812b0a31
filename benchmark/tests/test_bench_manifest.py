"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""
import json
import re

import pytest

from benchmark import run

MANIFEST = json.loads((run.ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
CELLS = [w['name'] for w in MANIFEST['workloads']]


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == KEYS
    assert 1 <= len(MANIFEST['paths']) <= 16
    assert all(PATH.match(p) and not p.startswith('/') and '..' not in p.split('/')
               for p in MANIFEST['paths'])
    assert 1 <= len(MANIFEST['command']) <= 32 and all(line(w) for w in MANIFEST['command'])
    assert isinstance(MANIFEST['run_seconds'], int) and 1 <= MANIFEST['run_seconds'] <= 51
    assert len((run.ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits: 2 + 14 cells runs of run_seconds + 60 s,
    # 2 x 90 s a cell to compile and 1200 s spare, in 43,200 s
    assert (2 + 14 * 24) * (MANIFEST['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


def test_command_names_only_files_under_paths():
    for word in MANIFEST['command'][1:]:
        if '/' in word:
            assert any(word.startswith(p + '/') for p in MANIFEST['paths'])
            assert (run.ROOT / word).is_file()


def test_names_and_units():
    configs = [c['name'] for c in MANIFEST['configs']]
    metrics = [m['name'] for kind in ('end_to_end', 'per_layer') for m in MANIFEST[kind]]
    for names in (configs, CELLS, metrics):
        assert len(names) == len(set(names))
        assert all(NAME.match(name) for name in names), names
    for kind in ('end_to_end', 'per_layer'):
        for m in MANIFEST[kind]:
            assert UNIT.match(m['unit']), m
            assert m['better'] in ('lower', 'higher') and m['source'] in SOURCES


def test_configs():
    assert 1 <= len(MANIFEST['configs']) <= 24
    files = set()
    for c in MANIFEST['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert line(c['source']) and line(c['why'])
        assert any(c['file'].startswith(p + '/') for p in MANIFEST['paths'])
        assert c['file'] not in files
        files.add(c['file'])
        data = json.loads((run.ROOT / c['file']).read_text())
        assert data['name'] == c['name'] and data['reduced'] == c['reduced']
        assert len(c['reduced']) <= 16 and all(NAME.match(k) for k in c['reduced'])


def test_every_config_has_a_cell_and_cells_are_unique():
    used = {w['config'] for w in MANIFEST['workloads']}
    assert used == {c['name'] for c in MANIFEST['configs']}
    pairs = [(w['config'], w['traffic']) for w in MANIFEST['workloads']]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files(cell):
    w = next(x for x in MANIFEST['workloads'] if x['name'] == cell)
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert w['chips'] in (1, 4) and line(w['why']) and NAME.match(w['traffic'])
    manifest, _, spec, config = run.cell(cell, MANIFEST)
    assert (run.BENCH / 'entries' / f"{spec['entry']}.py").is_file()
    assert spec['limits'] and all(v > 0 for v in spec['limits'].values())
    for layer, (first, last) in config['layers'].items():
        assert isinstance(first, str) and isinstance(last, str)


def test_four_chip_cells_within_their_share():
    four = sum(w['chips'] == 4 for w in MANIFEST['workloads'])
    assert four <= max(1, len(CELLS) // 4)


def test_end_to_end_metrics():
    e2e = {m['name']: m for m in MANIFEST['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    assert 'workloads' not in e2e['setup_s']
    for m in e2e.values():
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source', 'workloads'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for cell in CELLS:
        reported = [m for m in run.metrics_of(MANIFEST, 'end_to_end', cell)]
        assert 'setup_s' in [m['name'] for m in reported] and len(reported) >= 2
        assert run.metrics_of(MANIFEST, 'per_layer', cell)


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m['name'] for m in MANIFEST['end_to_end']}
    layers = {}
    for m in MANIFEST['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
        assert line(m['layer']) and m['moves'] in e2e
        for cell in m.get('workloads', CELLS):
            assert cell in CELLS
            assert m['moves'] in [x['name'] for x in run.metrics_of(MANIFEST, 'end_to_end', cell)]
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
        layers.setdefault(m['layer'].lower(), set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize('kind', ['end_to_end', 'per_layer'])
def test_every_metric_has_a_reader(kind):
    for m in MANIFEST[kind]:
        assert (run.BENCH / 'metrics' / f"{run.reader_of(m['name'])}.py").is_file(), m['name']


def test_files_under_paths_are_named_from_name_characters():
    for p in MANIFEST['paths']:
        for f in (run.ROOT / p).rglob('*'):
            if '__pycache__' in f.parts or not f.is_file():
                continue
            rel = f.relative_to(run.ROOT).as_posix()
            assert all(NAME.match(part) for part in rel.split('/')), rel
