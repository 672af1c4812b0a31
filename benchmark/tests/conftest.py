"""Shared helpers of the benchmark's tests: the repository on ``sys.path``,
tiny CPU sizes of every cell, and the ``cuda`` fixture of the tests marked
``gpu``."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cell at a size the CPU runs in seconds: 16-px raw patches (32-px
# RGB), two patches a call, a pool of three batches, a sample of three calls
TINY = {'config': {'flow': {'raw_patch_size': 16}},
        'workload': {'traffic': {'batch': 2, 'side': 32, 'pool': 3}, 'warmup_calls': 1,
                     'trace_calls': 2, 'judge': {'sample': 3, 'sample_from': 4}}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')
