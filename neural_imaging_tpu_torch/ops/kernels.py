"""
Fixed filters (numpy/scipy) for the ISP and the manipulations, laid out HWIO
like the reference's. Copy of the filter functions of
``neural_imaging_tpu/ops/kernels.py`` that this port uses.
"""
import numpy as np

from neural_imaging_tpu_torch.data.bayer import CFA_OFFSETS, PLANE_RGB, STACK_PLANES

# Example camera-RGB → sRGB conversion matrix (rows act on RGB vectors); the
# initial value of INet's color stage.
EXAMPLE_SRGB = np.array([[1.82691061, -0.65497452, -0.17193617],
                         [-0.00683982, 1.33216381, -0.32532394],
                         [0.06269717, -0.40055895, 1.33786178]])


def upsampling_kernel(cfa_pattern='gbrg'):
    """(4, 12) 1x1 kernel scattering an RGGB stack into depth_to_space(2)
    channel order: channel (i*2+j)*3 + c is RGB channel c of subpixel (i, j)."""
    off = CFA_OFFSETS[cfa_pattern.upper()]
    upk = np.zeros((4, 12))
    for plane_idx, plane in enumerate(STACK_PLANES):
        r, c = off[plane]
        upk[plane_idx, (r * 2 + c) * 3 + PLANE_RGB[plane]] = 1
    return upk


def gamma_kernels():
    """Kernels of the pre-trained 2-layer tanh gamma network, applied per RGB
    channel through block-diagonal 1x1 convs."""
    d1k = np.array([2.9542332, 17.780445, 0.6280197, 0.40384966])
    d1b = np.array([0.4047071, 1.1489044, -0.17624384, 0.47826886])
    d2k = np.array([0.44949612, 0.78081024, 0.97692937, -0.24265033])
    d2b = -0.4702738

    gamma_d1k = np.zeros((3, 12))
    gamma_d1b = np.zeros((12,))
    gamma_d2k = np.zeros((12, 3))
    gamma_d2b = np.zeros((3,))
    for r in range(3):
        gamma_d1k[r, r * 4:r * 4 + 4] = d1k
        gamma_d1b[r * 4:r * 4 + 4] = d1b
        gamma_d2k[r * 4:r * 4 + 4, r] = d2k
        gamma_d2b[r] = d2b
    return gamma_d1k, gamma_d1b, gamma_d2k, gamma_d2b


def bilin_kernel(kernel=3):
    """Bilinear demosaicing kernel (kernel, kernel, 3, 3), zero-padded beyond 3x3."""
    g_kern = np.array([[0, .25, 0], [.25, 1, .25], [0, .25, 0]])
    rb_kern = np.array([[.25, .5, .25], [.5, 1, .5], [.25, .5, .25]])

    dmf = np.zeros((3, 3, 3, 3), dtype=np.float32)
    dmf[:, :, 0, 0] = rb_kern
    dmf[:, :, 1, 1] = g_kern
    dmf[:, :, 2, 2] = rb_kern
    if kernel > 3:
        pad = (kernel - 3) // 2
        dmf = np.pad(dmf, ((pad, pad), (pad, pad), (0, 0), (0, 0)))
    return dmf


def gkern(kernlen=5, std=0.83):
    """Normalized 2-D Gaussian kernel."""
    # scipy.signal.windows.gaussian(kernlen, std), in its arithmetic (scipy.signal
    # takes seconds to import)
    n = np.arange(0, kernlen) - (kernlen - 1.0) / 2.0
    g1 = np.exp(-n ** 2 / (2 * std * std))
    g2 = np.outer(g1, g1)
    return g2 / g2.sum()


def repeat_2dfilter(f, channels=3, pad=0):
    """Tile a 2-D filter along the channel diagonal → (k, k, channels, channels)."""
    f = np.asarray(f, dtype=np.float64)
    rf = np.zeros((f.shape[0] + 2 * pad, f.shape[1] + 2 * pad, channels, channels))
    for r in range(channels):
        rf[:, :, r, r] = np.pad(f, pad)
    return rf


def center_mask_2dfilter(f_size, channels):
    """Indicator for the center tap of each diagonal channel pair."""
    ind = np.zeros((f_size, f_size, channels, channels))
    for r in range(channels):
        ind[f_size // 2, f_size // 2, r, r] = 1
    return ind
