"""
Build the port's CUDA sources (``csrc/*.cu``) with ``nvcc`` into shared
libraries with a plain C interface, loaded with ``ctypes``.

No PyTorch headers, no ``torch.utils.cpp_extension`` and no ``ninja``: a
source builds in seconds. Libraries go to ``neural_imaging_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. The compiler's output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside each library
as ``<name>.log``.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else
    the toolkit's default location."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    if shutil.which('nvcc'):
        candidates.append(Path(shutil.which('nvcc')))
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for path in candidates:
        if path.is_file():
            return path
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256(
        (CSRC_DIR / f'{name}.cu').read_bytes() + ' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(names):
    """Compile every ``csrc/<name>.cu`` whose library is missing, one ``nvcc``
    per source, all started together. Returns {name: library path}; raises
    with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [str(nvcc), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        out.with_suffix('.log').write_text(log)
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('CUDA build failed:\n' + '\n'.join(failed))
    return {name: library_path(name) for name in names}


@functools.lru_cache()
def load(name):
    """Build (if needed) and load ``csrc/<name>.cu`` as a ``ctypes.CDLL``."""
    return ctypes.CDLL(str(build([name])[name]))
