"""
The yardstick's arithmetic: the card's peaks, and the work of one launch of
each hand-written kernel (K1-K4), frozen here so that a change to the
program cannot move its own bound.

A launch's least time is the larger of its operations over the float32 rate
(no tensor cores: the kernels compute in float32 on the CUDA cores) and its
bytes over the memory rate. Operations are counted from the mathematics the
kernel computes, one per add, multiply, compare, select, division, square
root, logarithm or exponential (an FMA is two), whatever instructions an
implementation issues; bytes are each input read once and each output
written once.
"""

# NVIDIA's data sheet of the H100 SXM, dense, at its 700 W limit
PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bf16_flops': 989.4e12, 'f32_flops': 67e12, 'hbm_bytes': 3.35e12},
}

# K1, per pixel of a centred plane: the 8-point DCT along rows and columns
# and the inverse along both (4 passes of 8 multiply-adds, 16 operations
# each), then the division by the table, the rounding and the multiplication
K1_OPS_PER_PIXEL = 4 * 16 + 3

# K2-K4, per (value, codeword) pair, from the soft-codebook formula
# w_j ∝ exp(-(ν+1)/2 log1p((γ(x - c_j))² / ν)):
# the log-weight: x - c, × γ, square, / ν, log1p, × -(ν+1)/2         6
# the running max and first argmax: compare, select                  2
# exp(lw - max): subtract, exp                                        2
# K2's sums Σ w and Σ w c: add, multiply-add                          3
# K3's: Σ w, Σ w c, and with d lw/dx = -(ν+1)γ²(x - c)/(ν + (γ(x - c))²)
# (add, two multiplies, division: 4) Σ w dlw and Σ w dlw c (2 + 3)    12
# K4 also accumulates the codeword gradient w (1 - dlw (c - soft))
# / s × g: subtract, multiply, subtract, multiply-add                  5
K2_OPS_PER_PAIR = 6 + 2 + 2 + 3
K3_OPS_PER_PAIR = 6 + 2 + 2 + 3 + 4 + 2 + 3
K4_OPS_PER_PAIR = K3_OPS_PER_PAIR + 5
# per value: K2 the soft value's division; K3 the gradient
# g' (B - C A / s) / s with the entropy term added to g (2 divisions, 5);
# K4 also the soft value (a division)
K2_OPS_PER_VALUE, K3_OPS_PER_VALUE, K4_OPS_PER_VALUE = 1, 7, 8


def k1(p, h, w):
    """(operations, bytes) of K1 on planes (P, H, W): the planes read, the
    reconstruction and the coefficients written, the P tables and the DCT
    matrix read, all float32."""
    pixels = p * h * w
    return K1_OPS_PER_PIXEL * pixels, 4 * (3 * pixels + 64 * p + 64)


def k2(n, codes=32):
    """K2 on N values: z read, the soft value and the int32 index written,
    the codebook read."""
    return n * (codes * K2_OPS_PER_PAIR + K2_OPS_PER_VALUE), 12 * n + 4 * codes


def k3(n, codes=32):
    """K3 on N values: z and g read, dz written, the codebook and the
    per-codeword entropy term read."""
    return n * (codes * K3_OPS_PER_PAIR + K3_OPS_PER_VALUE), 12 * n + 8 * codes


def k4(n, codes=32):
    """K4 on N values: K3's bytes and the codeword gradient written."""
    return n * (codes * K4_OPS_PER_PAIR + K4_OPS_PER_VALUE), 12 * n + 12 * codes


def bound_s(work, peaks):
    """Least seconds of a launch of ``work`` (operations, bytes)."""
    ops, nbytes = work
    return max(ops / peaks['f32_flops'], nbytes / peaks['hbm_bytes'])
