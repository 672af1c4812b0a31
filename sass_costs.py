#!/usr/bin/env python3
"""
How many instructions the math functions of the codebook kernels (K2-K4,
``neural_imaging_tpu_torch/csrc/codebook.cu``) cost on sm_90a, counted in the
compiled code. ``neural_imaging_tpu_torch/ops/hopper/codebook.py`` builds the kernels'
work (``codebook_*_work``), on which ``chip_smoke.py`` bounds them, from these counts.

Each probe kernel below writes ``f(a) + b`` for one function ``f``: the
accurate ``log1pf``, ``expf`` and the IEEE division, and the forms that K2
and K4 use for L = 32 (K2's weights' exp as ``ex2.approx`` of x log2 e, and
the division by the constant v through its reciprocal with two FMAs, v and
1/v being kernel parameters as there); the ``add`` probe writes ``a + b``.
All are built with the flags of ``ops/hopper/_build.py`` and disassembled
with ``cuobjdump -sass``. A
function's cost is the number of instructions its probe runs from entry to
``EXIT`` on its common path (``common_path``), less the ``add`` probe's
count.

    python3 sass_costs.py

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a card. Prints each
probe's instructions, then one JSON line: {function: instructions}.
"""
import json
import re
import subprocess
import tempfile
from pathlib import Path

from neural_imaging_tpu_torch.ops.hopper import _build

PROBES = {'add': 'a[i] + b[i]', 'log1pf': 'log1pf(a[i]) + b[i]',
          'expf': 'expf(a[i]) + b[i]', 'div': 'a[i] / b[i] + b[i]',
          'exp_approx': 'exp_approx(a[i]) + b[i]',
          'div_by_v': 'fmaf(fmaf(-(a[i] * rv), v, a[i]), rv, a[i] * rv) + b[i]'}
# as csrc/codebook.cu defines them
HELPERS = """
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.44269504088896341f));
  return y;
}
"""
SOURCE = HELPERS + '\n'.join(
    f'extern "C" __global__ void probe_{name}(const float* __restrict__ a, '
    f'const float* __restrict__ b, float* __restrict__ o, float v, float rv) {{\n'
    f'  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n'
    f'  o[i] = {expr};\n}}' for name, expr in PROBES.items())
INSTRUCTION = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;')
FORWARD_BRANCH = re.compile(r'^@!?U?P\d+\s+BRA\s+(0x[0-9a-f]+)$')
# an immediate moved into a register, or a load of the scalar parameters v
# and 1/v (after the three pointers, at 0x228 and 0x22c): constants that a
# loop keeps in registers
CONSTANT = re.compile(r'^(MOV|HFMA2\.MMA|IMAD\.MOV\.U32)\s+R\d+,(?!.*\bU?R\d)'
                      r'|^ULDC(\.64)?\s+UR\d+, c\[0x0\]\[0x22[89a-f]\]$')

def disassemble():
    """{probe name: SASS listing of its kernel}."""
    nvcc = _build.nvcc_path()
    flags = [f for f in _build.NVCC_FLAGS if f not in ('-shared', '-Xcompiler', '-fPIC')]
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = Path(tmp) / 'probes.cu', Path(tmp) / 'probes.cubin'
        src.write_text(SOURCE + '\n')
        subprocess.run([str(nvcc), *flags, '-cubin', '-o', str(cubin), str(src)],
                       check=True, capture_output=True, text=True)
        sass = subprocess.run([str(nvcc.parent / 'cuobjdump'), '-sass', str(cubin)],
                              check=True, capture_output=True, text=True).stdout
    listings = {}
    for part in sass.split('Function : ')[1:]:
        name, _, body = part.partition('\n')
        listings[name.strip().removeprefix('probe_')] = body
    return listings


def common_path(listing):
    """The instructions a thread runs from entry to the first EXIT when every
    predicated forward branch on the way is taken: the code those branches
    skip handles special operands (a negative or infinite log1pf argument;
    the division's out-of-line slow path). Immediates moved into registers
    and loads of the scalar parameters are left out: in a loop they stay in
    registers."""
    path, skip_to = [], -1
    for address, text in INSTRUCTION.findall(listing):
        if int(address, 16) < skip_to:
            continue
        branch = FORWARD_BRANCH.match(text)
        if branch:
            skip_to = int(branch.group(1), 16)
        if not CONSTANT.match(text):
            path.append(text)
        if text == 'EXIT':
            break
    return path

def main():
    listings = disassemble()
    paths = {name: common_path(listings[name]) for name in PROBES}
    for name, path in paths.items():
        print(f'[{name}] {len(path)} instructions: ' + ' | '.join(path), flush=True)
    costs = {name: len(paths[name]) - len(paths['add']) for name in PROBES if name != 'add'}
    version = subprocess.run([str(_build.nvcc_path()), '--version'], check=True,
                             capture_output=True, text=True).stdout.strip().splitlines()[-1]
    print(json.dumps({'nvcc': version, 'arch': 'sm_90a', 'instructions': costs}))


if __name__ == '__main__':
    main()
