"""The control of every cell, on the card at the cell's own size: the plain
reference put in the program's place in TF32, the precision below the
float32 the configurations state, has to come out not correct; so has each
planted fault. ``tools/readings.py`` gives the same readings on more seeds."""
import json

import pytest

from benchmark import judge, run
from benchmark.tools import readings

MANIFEST = json.loads((run.ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in MANIFEST['workloads']]


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_and_the_faults_are_not_correct(cell, cuda):
    out = readings.readings(cell, 2 ** 31 + 11, cuda)
    assert out['control_fails'], out
    for fault in ('half_batch', 'answer'):
        if fault in out:
            assert not judge.verdict(out[fault], out['limits'])[1], (fault, out)
