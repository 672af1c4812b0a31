"""What the benchmark loads: nothing whose top-level module name, taken whole,
is jax, jaxlib, flax, optax or the JAX package; the reference nothing of the
port; and no result without a card or without the program."""
import ast
import shutil
import subprocess
import sys

import pytest

from benchmark import run

PYTHON = sys.executable


def python(code, cwd=run.ROOT):
    return subprocess.run([PYTHON, '-c', code], cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_a_run_loads_no_jax():
    code = ('import sys, json; sys.path.insert(0, "."); import torch; '
            'sys.path.insert(0, "benchmark/tests"); from conftest import TINY; '
            'from benchmark import run; '
            'r = run.run("m_quality-train", 5, 0.1, 0, "cpu", overrides=TINY); '
            'print(json.dumps(run.forbidden_modules()))')
    out = python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_names_are_whole_top_level_names():
    assert set(run.FORBIDDEN) == {'jax', 'jaxlib', 'flax', 'optax', 'neural_imaging_tpu'}
    assert run.forbidden_modules(['neural_imaging_tpu_torch.ops', 'jaxtyping', 'flaxen']) == []
    assert run.forbidden_modules(['neural_imaging_tpu.ops', 'jax.numpy', 'optax']) == [
        'jax', 'neural_imaging_tpu', 'optax']


def reference_imports():
    for path in (run.BENCH / 'reference').glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                yield node.module


def test_the_reference_imports_nothing_of_the_port():
    tops = {name.split('.')[0] for name in reference_imports()}
    assert tops <= {'numpy', 'torch', 'benchmark', 'contextlib', 'functools', 'importlib'}, tops
    assert all(name.startswith('benchmark.reference') for name in reference_imports()
               if name.startswith('benchmark'))
    out = python('import sys; sys.path.insert(0, "."); '
                 'import benchmark.reference.joint_flow, benchmark.reference.ops; '
                 'import benchmark.reference.isp_inet, benchmark.reference.isp_onet; '
                 'print(sorted({m.split(".")[0] for m in sys.modules} & '
                 '{"neural_imaging_tpu_torch", "neural_imaging_tpu", "jax"}))')
    assert out.returncode == 0 and out.stdout.strip() == '[]', out.stderr


def test_no_result_without_a_card():
    out = subprocess.run([PYTHON, 'benchmark/run.py', '--workload', 'm_quality-train', '--seed',
                          '3', '--seconds', '1', '--trace', '0'], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={'CUDA_VISIBLE_DEVICES': '', 'PATH': '/usr/bin:/bin'})
    assert out.returncode != 0 and out.stdout == ''


def test_no_result_without_the_program(tmp_path):
    shutil.copy(run.ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(run.BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = python('import sys; sys.path.insert(0, "."); import json; '
                 'sys.path.insert(0, "benchmark/tests"); from conftest import TINY; '
                 'from benchmark import run; '
                 'print(json.dumps(run.run("m_quality-train", 5, 0.1, 0, "cpu", '
                 'overrides=TINY)))', cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ''


@pytest.mark.parametrize('module', ['run', 'trace', 'judge', 'generator', 'system', 'work',
                                    'kernel_timing'])
def test_harness_modules_import_no_jax(module):
    out = python(f'import sys; sys.path.insert(0, "."); import benchmark.{module}; '
                 'print(sorted({m.split(".")[0] for m in sys.modules} & '
                 '{"jax", "jaxlib", "flax", "optax", "neural_imaging_tpu"}))')
    assert out.returncode == 0 and out.stdout.strip() == '[]', out.stderr
