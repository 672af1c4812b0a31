"""The port runs on a machine without JAX, flax, optax, PIL or imageio, and
without the JAX package: its modules and chip_smoke.py must import with all
of those blocked. Its entry points default to CUDA and must refuse to run
without a card, and chip_smoke.py must fail without one."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import neural_imaging_tpu_torch
from neural_imaging_tpu_torch.models import forensics, jpeg, pipelines
from neural_imaging_tpu_torch.utils import device as device_utils
from neural_imaging_tpu_torch.workflows import manipulation_classification

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'PIL', 'imageio', 'neural_imaging_tpu')


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(neural_imaging_tpu_torch.__path__,
                                                        'neural_imaging_tpu_torch.'))


def run_python(code, **env):
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **env})


def test_port_and_chip_smoke_import_without_jax_pil_imageio_or_the_jax_package():
    modules = port_modules() + ['chip_smoke']
    assert 'neural_imaging_tpu_torch.ops.hopper.jpeg8x8' in modules
    code = '\n'.join([
        'import importlib, sys',
        f'for name in {BLOCKED!r}:',
        '    sys.modules[name] = None',
        f'for name in {modules!r}:',
        '    importlib.import_module(name)',
        f'leaked = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} '
        'and sys.modules[m] is not None]',
        'assert not leaked, leaked',
        'print("imported", len(sys.modules))'])
    result = run_python(code)
    assert result.returncode == 0, result.stderr
    assert 'imported' in result.stdout


def test_chip_smoke_fails_without_a_gpu():
    result = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT, capture_output=True,
                            text=True, timeout=300,
                            env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout


@pytest.mark.parametrize('entry', [
    lambda: device_utils.resolve_device(),
    lambda: pipelines.INet(),
    lambda: forensics.FAN(n_classes=5),
    lambda: jpeg.JPEG(50),
    lambda: jpeg.DifferentiableJPEG(50),
    lambda: manipulation_classification.ManipulationClassification(raw_patch_size=16),
])
def test_entry_points_default_to_cuda_and_refuse_without_it(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry()


def test_cpu_is_taken_only_when_asked():
    assert device_utils.resolve_device('cpu') == torch.device('cpu')
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
