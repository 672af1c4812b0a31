"""
Menon-Andriani-Calvagno (2007) DDFAPD demosaicing (directional filtering with
a-posteriori decision, IEEE TIP 16(1):132-141) in PyTorch float64, on any
device: a port of ``neural_imaging_tpu/data/menon.py``, which computes it in
numpy. Steps:

1. directional green estimates G_H/G_V with the 5-tap FIR + Laplacian correction,
2. chrominance-gradient classifier over an asymmetric 5x5 window picks the
   interpolation direction per pixel,
3. R/B reconstruction from directional color-difference averages,
4. optional refining step on the color-difference planes.

The filters run as ``raw.convolve`` / ``raw.convolve1d``, which sum in
scipy.ndimage's order, so on the CPU the result equals the reference's bit
for bit. The direction decision ``del_V >= del_H`` compares two such sums.
"""
import numpy as np
import torch

from neural_imaging_tpu_torch.data.raw import cfa_masks, convolve, convolve1d

_H0 = np.array([0.0, 0.5, 0.0, 0.5, 0.0])
_H1 = np.array([-0.25, 0.0, 0.5, 0.0, -0.25])

# classifier window (paper eq. 9: sum over the causal 5x5 neighborhood)
_K = np.array([[0.0, 0.0, 1.0, 0.0, 1.0],
               [0.0, 0.0, 0.0, 1.0, 0.0],
               [0.0, 0.0, 3.0, 0.0, 3.0],
               [0.0, 0.0, 0.0, 1.0, 0.0],
               [0.0, 0.0, 1.0, 0.0, 1.0]])


def _shift(x, dy, dx):
    """Shift with edge replication: out(i,j) = x(i+dy, j+dx)."""
    h, w = x.shape
    rows = torch.arange(h, device=x.device).add_(dy).clamp_(0, h - 1)
    cols = torch.arange(w, device=x.device).add_(dx).clamp_(0, w - 1)
    return x.index_select(0, rows).index_select(1, cols)


def _dir_avg(x, horizontal):
    """Average of the two distance-1 neighbors along the given direction."""
    if horizontal:
        return 0.5 * (_shift(x, 0, -1) + _shift(x, 0, 1))
    return 0.5 * (_shift(x, -1, 0) + _shift(x, 1, 0))


def _oriented_avg(x, horiz):
    """The distance-1 average along each pixel's decided direction."""
    return torch.where(horiz, _dir_avg(x, True), _dir_avg(x, False))


def directions(m, cfa_pattern):
    """From a float64 (h, w) mosaic tensor: the classifier's decision of
    every pixel (True: horizontal) and the horizontal and vertical green
    estimates."""
    R_m, _, B_m = cfa_masks(m.shape, cfa_pattern, m.device)
    X_m = R_m | B_m  # sites where green is missing
    fir = _H0 + _H1
    G_H = torch.where(X_m, convolve1d(m, fir, axis=1), m)
    G_V = torch.where(X_m, convolve1d(m, fir, axis=0), m)
    C_H = torch.where(X_m, m - G_H, 0.0)
    C_V = torch.where(X_m, m - G_V, 0.0)
    D_H = torch.abs(C_H - _shift(C_H, 0, 2))
    D_V = torch.abs(C_V - _shift(C_V, 2, 0))
    del_H = convolve(D_H, _K)
    del_V = convolve(D_V, _K.T)
    return del_V >= del_H, G_H, G_V  # horizontal when the vertical gradient dominates


def demosaic_menon(mosaic, cfa_pattern, refine=True):
    """DDFAPD demosaic of a [0, 1] (h, w) mosaic tensor into (h, w, 3) RGB,
    float64 on the mosaic's device."""
    m = mosaic.to(torch.float64)
    R_m, G_m, B_m = cfa_masks(m.shape, cfa_pattern, m.device)
    X_m = R_m | B_m

    # --- 1.-2. directional green estimates and the decision -----------------
    horiz, G_H, G_V = directions(m, cfa_pattern)
    G = torch.where(X_m, torch.where(horiz, G_H, G_V), m)
    del G_H, G_V

    # --- 3. R/B reconstruction ------------------------------------------------
    # phase masks: rows containing R (resp. B) samples
    R_rows = R_m.any(dim=1, keepdim=True).expand_as(R_m)
    B_rows = B_m.any(dim=1, keepdim=True).expand_as(B_m)

    R = torch.where(R_m, m, 0.0)
    B = torch.where(B_m, m, 0.0)

    # at G sites: average the in-row (or in-column) color difference
    R, B = _green_sites(G, R, B, R_m, G_m, B_m, R_rows, B_rows)

    # at B sites (R unknown) / R sites (B unknown): directional average of the
    # just-completed color difference, along the classifier's direction
    dR = torch.where(R_m | G_m, R - G, 0.0)
    dB = torch.where(B_m | G_m, B - G, 0.0)
    R = torch.where(B_m, G + _oriented_avg(dR, horiz), R)
    B = torch.where(R_m, G + _oriented_avg(dB, horiz), B)

    if refine:
        R, G, B = _refine(R, G, B, R_m, G_m, B_m, horiz, R_rows, B_rows)

    return torch.stack([R, G, B], dim=-1)


def _green_sites(G, R, B, R_m, G_m, B_m, R_rows, B_rows):
    """R and B at the green sites from the row's (column's) color differences."""
    dR = torch.where(R_m, R - G, 0.0)
    dB = torch.where(B_m, B - G, 0.0)
    R = torch.where(G_m & R_rows, G + _dir_avg(dR, True), R)
    R = torch.where(G_m & B_rows, G + _dir_avg(dR, False), R)
    B = torch.where(G_m & B_rows, G + _dir_avg(dB, True), B)
    B = torch.where(G_m & R_rows, G + _dir_avg(dB, False), B)
    return R, B


def _refine(R, G, B, R_m, G_m, B_m, horiz, R_rows, B_rows):
    """Refining step (paper §V): low-pass the color-difference planes along the
    decision direction and re-derive each channel from the refined differences."""
    # 1. refine G at R/B sites: G = X + directional 2-tap mean of (G - X)
    dGR = G - R
    dGB = G - B
    G = torch.where(R_m, R + _oriented_avg(dGR, horiz), G)
    G = torch.where(B_m, B + _oriented_avg(dGB, horiz), G)
    del dGR, dGB

    # 2. re-derive R/B at G sites from the refined green
    R, B = _green_sites(G, R, B, R_m, G_m, B_m, R_rows, B_rows)

    # 3. re-derive R at B sites and B at R sites
    dR = torch.where(~B_m, R - G, 0.0)
    dB = torch.where(~R_m, B - G, 0.0)
    R = torch.where(B_m, G + _oriented_avg(dR, horiz), R)
    B = torch.where(R_m, G + _oriented_avg(dB, horiz), B)
    return R, G, B
