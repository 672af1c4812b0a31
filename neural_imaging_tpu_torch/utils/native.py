"""
Build the repository's host C++ sources (``native/*/*.cpp``) with ``g++``
into shared libraries, loaded with ``ctypes``.

``g++ -O3 -fPIC -shared -std=c++17`` (no ``-march=native``, so a library
runs on any x86-64 host) into ``neural_imaging_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags: an edited source
is rebuilt, an unchanged one reused. A failed build raises with the
compiler's output; no caller falls back to anything else.
"""
import hashlib
import os
import subprocess

from neural_imaging_tpu_torch.ops.hopper._build import BUILD_DIR

CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17')


def library_path(source, stem):
    """Where the library ``lib<stem>-<hash>.so`` built from ``source`` lives."""
    digest = hashlib.sha256(source.read_bytes() + ' '.join(CXX_FLAGS).encode())
    return BUILD_DIR / f'lib{stem}-{digest.hexdigest()[:16]}.so'


def build(source, stem):
    """Compile ``source`` if its library is missing; returns the library path.
    Raises RuntimeError with the compiler's output if the build fails."""
    out = library_path(source, stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    try:
        result = subprocess.run(['g++', *CXX_FLAGS, '-o', str(tmp), str(source)],
                                capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'{stem} build failed: cannot run g++: {e}') from e
    if result.returncode != 0:
        raise RuntimeError(f'{stem} build failed (g++ exited {result.returncode}):\n'
                           f'{result.stdout}{result.stderr}')
    os.replace(tmp, out)
    return out
