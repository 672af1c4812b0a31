#!/usr/bin/env python3
"""
Whether the codebook kernels' division by the constant v
(``neural_imaging_tpu_torch/csrc/codebook.cu``, ``Weights::div_v``: q0 = t
(1/v), then t / v as q0 + (t - q0 v) (1/v) with two FMAs) rounds to the
IEEE quotient for every float t in [2^-64, 2^64], the range in which K2 and
K4 use it (they take it for 2^-10 <= v <= 2^10).

A small C program, built with the host's C compiler (whose ``fmaf``, float
product and float division round as the card's FFMA, FMUL and IEEE division
do), compares the two at each v: for every float t of the range, or for
``--sample`` random ones.

    python3 check_division.py [--v 50 7.5 ...] [--sample K] [--seed 0]

Prints one JSON line: {"mismatches": {v: count}, "checked": t per v}. Needs
``cc`` (or ``gcc``).
"""
import argparse
import json
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the ends of the range of v, and values between them
V_VALUES = (2.0 ** -10, 0.0123, 0.3, 0.7, 7.5, 49.99, 50.0, 2.0 ** 10)
SOURCE = r'''
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static float div_v(float t, float v, float rv) {
  const float q0 = t * rv;
  return fmaf(fmaf(-q0, v, t), rv, q0);
}

int main(int argc, char** argv) {
  const float v = strtof(argv[1], NULL), rv = 1.0f / v;
  const unsigned long long sample = strtoull(argv[2], NULL, 10);
  uint64_t state = strtoull(argv[3], NULL, 10) * 2654435761u + 1;
  const float lo = ldexpf(1.0f, -64), hi = ldexpf(1.0f, 64);
  uint32_t b0, b1;
  memcpy(&b0, &lo, 4);
  memcpy(&b1, &hi, 4);
  const unsigned long long n = sample ? sample : (unsigned long long)(b1 - b0) + 1;
  unsigned long long bad = 0;
  for (unsigned long long i = 0; i < n; ++i) {
    uint32_t bits = (uint32_t)(b0 + i);
    if (sample) {
      state ^= state << 13;
      state ^= state >> 7;
      state ^= state << 17;
      bits = b0 + (uint32_t)(state % ((uint64_t)(b1 - b0) + 1));
    }
    float t;
    memcpy(&t, &bits, 4);
    volatile float ieee = t / v;
    const float fast = div_v(t, v, rv);
    bad += memcmp((const void*)&ieee, &fast, 4) != 0;
  }
  printf("%llu %llu\n", bad, n);
  return 0;
}
'''


def build(directory):
    """The checker, compiled into ``directory``."""
    cc = shutil.which('cc') or shutil.which('gcc')
    if cc is None:
        raise RuntimeError('check_division: needs a C compiler (cc or gcc)')
    src, exe = Path(directory) / 'div_v.c', Path(directory) / 'div_v'
    src.write_text(SOURCE)
    subprocess.run([cc, '-O2', '-ffp-contract=off', '-o', str(exe), str(src), '-lm'],
                   check=True, capture_output=True, text=True)
    return exe


def check(v_values=V_VALUES, sample=0, seed=0):
    """{v: mismatches} and the count of t checked at each v."""
    with tempfile.TemporaryDirectory() as tmp:
        exe = build(tmp)

        def one(v):
            out = subprocess.run([str(exe), repr(float(v)), str(sample), str(seed)],
                                 check=True, capture_output=True, text=True).stdout.split()
            return int(out[0]), int(out[1])
        with ThreadPoolExecutor(max_workers=len(v_values)) as pool:
            results = list(pool.map(one, v_values))
    return {float(v): bad for v, (bad, _) in zip(v_values, results)}, results[0][1]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--v', type=float, nargs='+', default=list(V_VALUES))
    parser.add_argument('--sample', type=int, default=0, help='random t per v (0: every t)')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    mismatches, checked = check(args.v, args.sample, args.seed)
    print(json.dumps({'mismatches': mismatches, 'checked': checked}))


if __name__ == '__main__':
    main()
