"""K5's CUDA source (``csrc/fan_conv.cu``) built for the host with g++, for
checking the kernels' indexing against their plain versions on the CPU.

The build reads the source as it is, with two lines rewritten for the host:
the dynamic shared memory declaration takes the running block's buffer, and
the launch runs the blocks on the CPU (``cuda_host/cuda_runtime.h``; its
threads are std::threads). Small shapes only: a block of 128 threads is 128
std::threads. ``load()`` returns the library with the argument types of
``ops/hopper/fan_conv.py``, or None where there is no g++ with C++20.
"""
import ctypes
import functools
import shutil
import subprocess
import tempfile
from pathlib import Path

from neural_imaging_tpu_torch.ops.hopper import _build, fan_conv

HERE = Path(__file__).resolve().parent
SHARED = 'extern __shared__ float4 smem4[];'
LAUNCH = 'kernel<<<grid, block, bytes, stream>>>(args);'
SUM_SHARED = '__shared__ double sums[kSumThreads];'


def host_source(source):
    """The source with its shared memory and its launch rewritten for the host."""
    for line in (SHARED, LAUNCH, SUM_SHARED):
        if line not in source:
            raise ValueError(f'csrc/fan_conv.cu no longer holds {line!r}')
    if source.count('<<<') != 1:
        raise ValueError('csrc/fan_conv.cu launches outside its launch helper')
    return (source.replace(SHARED, 'float4* smem4 = host_shared;')
            .replace(SUM_SHARED, 'double* const sums = reinterpret_cast<double*>(host_shared);')
            .replace(LAUNCH, 'host_launch(kernel, grid, block, bytes, args);'))


@functools.lru_cache()
def load():
    gxx = shutil.which('g++')
    if gxx is None:
        return None
    out = Path(tempfile.mkdtemp(prefix='fan_conv_host_'))
    src = out / 'fan_conv_host.cpp'
    src.write_text(host_source((_build.CSRC_DIR / f'{fan_conv.LIBRARY}.cu').read_text()))
    lib = out / 'libfan_conv_host.so'
    proc = subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                           f'-I{HERE / "cuda_host"}', '-o', str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if 'barrier' in proc.stderr and 'No such file' in proc.stderr:
            return None        # a g++ without C++20's <barrier>
        raise RuntimeError(f'g++ failed:\n{proc.stderr[-4000:]}')
    return fan_conv.bind(ctypes.CDLL(str(lib)))
