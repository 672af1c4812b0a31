"""
The one generator of the benchmark's inputs. A traffic mix is a JSON file
under ``workloads/`` whose ``traffic`` section this reads:

- ``inputs``: 'raw+rgb' (Bayer stacks of ``side`` / 2 px, mosaicked per
  ``cfa`` from linearized RGB targets of ``side`` px) or 'rgb' (RGB patches
  of ``side`` px);
- ``batch`` patches a call, a pool of ``pool`` batches cycled call after call;
- ``cell`` (px between the random control points of the smooth field),
  ``noise`` (standard deviation of the added noise) and ``gamma`` (of the
  linearization) shape the patches;
- ``placement``: 'device' (tensors on the card, as a device-resident trainer
  holds them) or 'host' (numpy arrays, as a validation loop hands them).

Everything is drawn on the device from one ``torch.Generator`` seeded with
the run's seed, in a few large calls, so a seed fixes the inputs and every
seed gives the same sizes.
"""
import torch
import torch.nn.functional as F

from benchmark.reference import isp


def smooth_rgb(gen, n, side, cell, noise, device):
    """(n, 3, side, side) in [0, 1]: a bilinear field over ``cell``-px control
    points plus Gaussian noise."""
    points = side // cell + 1
    coarse = torch.rand((n, 3, points, points), generator=gen, device=device)
    field = F.interpolate(coarse, size=(side, side), mode='bilinear', align_corners=True)
    return (field + noise * torch.randn((n, 3, side, side), generator=gen, device=device)).clamp(
        0, 1)


def make_pool(traffic, seed, device):
    """[(x, y or None)] of ``pool`` batches, NHWC float32: x the Bayer stacks
    (raw+rgb) or RGB patches, y the RGB targets (raw+rgb) or None."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = traffic['pool'] * traffic['batch']
    rgb = smooth_rgb(gen, n, traffic['side'], traffic['cell'], traffic['noise'], device)
    if traffic['inputs'] == 'raw+rgb':
        x = isp.mosaic(rgb ** traffic['gamma'], traffic.get('cfa', 'gbrg'))
        y = rgb
    elif traffic['inputs'] == 'rgb':
        x, y = rgb, None
    else:
        raise ValueError(f"unknown inputs {traffic['inputs']!r}")

    def nhwc(t):
        t = t.permute(0, 2, 3, 1).contiguous()
        return t.cpu().numpy() if traffic['placement'] == 'host' else t

    b = traffic['batch']
    return [(nhwc(x[i * b:(i + 1) * b]), None if y is None else nhwc(y[i * b:(i + 1) * b]))
            for i in range(traffic['pool'])]


def nchw(t, device):
    """A pool entry (NHWC numpy or tensor) as an NCHW float32 tensor on ``device``."""
    return torch.as_tensor(t, device=device).permute(0, 3, 1, 2).contiguous()
