"""
Full-image development in row bands over a list of devices: the port's
counterpart of the JAX package's spatial sharding (``develop_images.py
--devices``, whose ``('data', 'space')`` mesh splits an image's height and
lets XLA exchange the convolutions' halos).

A NIP's output row depends on the input rows within its receptive field
(:func:`receptive_rows`), so each band develops its rows from a window that
adds a halo of real neighbour rows at least that deep on each side where
the image goes on; at the image's true edges the NIP's own padding applies,
as on the whole image. The band's own rows of the result are then the whole
image's, up to the summation order of the devices' convolutions. UNet's
band edges and halos fall on multiples of 2^(n_steps - 1) stack rows, so
that each window's max-pool grid is the whole image's. A ClassicISP's
'percentile' or 'shift' brightness is a statistic of the whole image: the
bands first develop the sRGB image, the statistic is taken over all of it,
and the bands then normalize and tone their rows.

As the JAX CLI does, :func:`develop_image` reflect-pads the stack's height
to a multiple of the band count and crops the result to twice the original
height, so its last rows can differ from the unbanded development's when
the height does not divide.
"""
import copy
import math
from dataclasses import dataclass

import numpy as np
import torch

from neural_imaging_tpu_torch.ops import ops


@dataclass(frozen=True)
class Band:
    """Stack rows [start, stop) of a band, developed from rows [lo, hi)."""
    start: int
    stop: int
    lo: int
    hi: int


def receptive_rows(model):
    """(halo, align) of a NIP in stack rows: the depth of real neighbour rows
    a band needs on each side for its own rows to be exact, and the grid its
    band edges and halos must fall on."""
    from neural_imaging_tpu_torch.models import pipelines
    core = model.module
    if isinstance(core, pipelines.INetCore):
        # a (k - 1)/2-row reflect pad and conv at full resolution (2 rows a stack row)
        return math.ceil((core.kernel - 1) // 2 / 2), 1
    if isinstance(core, pipelines.ClassicISPCore):
        d = core.demosaicing
        radius = (d.kernel - 1) // 2 * max(1, len(d.c_filters))
        return math.ceil(radius / 2), 1
    if isinstance(core, pipelines.DNetCore):
        p = (core.kernel - 1) // 2
        return core.n_layers * p + math.ceil(p / 2), 1
    if isinstance(core, pipelines.UNetCore):
        n = core.n_steps
        align = 2 ** (n - 1)
        # two 3x3 convs a level down, one row of pooling and of upsampling a
        # level, two convs a level up, the head
        radius = 2 * (2 ** n - 1) + 4 * (2 ** (n - 1) - 1) + 1
        return -(-radius // align) * align, align
    if isinstance(core, pipelines.ONetCore):
        return 0, 1
    raise ValueError(f'no receptive field known for {type(core).__name__}')


def plan_bands(height, n, halo=0, align=1):
    """``n`` bands of a stack ``height`` rows high: edges on multiples of
    ``align`` (and the last at ``height``), each developed from a window
    ``halo`` rows deeper on each side, clipped to the image."""
    if height % align:
        raise ValueError(f'a stack of {height} rows does not fall on the NIP\'s grid of '
                         f'{align} rows')
    if halo % align:
        raise ValueError(f'a halo of {halo} rows is off the grid of {align} rows')
    units = height // align
    if not 1 <= n <= units:
        raise ValueError(f'{n} bands of a stack of {height} rows on a grid of {align}')
    edges = [round(units * i / n) * align for i in range(n + 1)]
    return [Band(a, b, max(0, a - halo), min(height, b + halo))
            for a, b in zip(edges[:-1], edges[1:])]


def pad_rows(stack, n):
    """The JAX CLI's reflect pad of a (h, w, 4) stack's height to a multiple
    of ``n``."""
    pad = (-stack.shape[0]) % n
    if not pad:
        return stack
    if torch.is_tensor(stack):
        return torch.cat([stack, stack[-2:-2 - pad:-1]], dim=0)
    return np.pad(stack, ((0, pad), (0, 0), (0, 0)), mode='reflect')


def _modules(model, devices):
    """The NIP's core on each distinct device (its own where it lives)."""
    out = {}
    for d in devices:
        d = torch.device(d)
        if d not in out:
            out[d] = model.module if d == model.device else copy.deepcopy(model.module).to(d)
    return out


def develop_bands(model, stack, devices, report=None):
    """Develop a (h, w, 4) RGGB stack (numpy or tensor, h on the band grid)
    with ``model`` in ``len(devices)`` bands, band i on ``devices[i]``;
    returns the (2h, 2w, 3) float32 image on the CPU, unclipped as
    ``model.process`` gives it. ``report``, a list, gets a dict per band:
    its rows, window and device, and on a card the peak memory it allocated
    above what was allocated before it (bytes)."""
    halo, align = receptive_rows(model)
    stack = torch.as_tensor(np.asarray(stack) if not torch.is_tensor(stack) else stack,
                            dtype=torch.float32)
    h, w = stack.shape[:2]
    bands = plan_bands(h, len(devices), halo, align)
    modules = _modules(model, devices)
    core = model.module
    brightness = getattr(core, 'brightness', '') or ''
    out = torch.empty((2 * h, 2 * w, 3), dtype=torch.float32)
    linear = []

    with torch.inference_mode():
        for band, d in zip(bands, devices):
            d = torch.device(d)
            if d.type == 'cuda':
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
                allocated = torch.cuda.memory_allocated(d)
            x = stack[band.lo:band.hi].to(d).permute(2, 0, 1)[None]
            top, rows = 2 * (band.start - band.lo), 2 * (band.stop - band.start)
            module = modules[d]
            if brightness:
                y = module.linear(x)[:, :, top:top + rows]
                linear.append(y)
            else:
                y = module(x)[:, :, top:top + rows]
                out[2 * band.start:2 * band.stop] = y[0].permute(1, 2, 0).cpu()
            if report is not None:
                entry = {'rows': (band.start, band.stop), 'window': (band.lo, band.hi),
                         'device': str(d)}
                if d.type == 'cuda':
                    torch.cuda.synchronize(d)
                    entry['peak_bytes'] = torch.cuda.max_memory_allocated(d) - allocated
                report.append(entry)
        if brightness:
            # the whole image's statistic, then each band's rows normalized and toned
            first = torch.device(devices[0])
            nhwc = [y.permute(0, 2, 3, 1).reshape(-1).to(first) for y in linear]
            if brightness == 'percentile':
                bottom, top_p = ops.percentile_bounds(torch.cat(nhwc), 0.5)
                scale = None
            else:
                total = sum(torch.sum(v) for v in nhwc)
                scale = 0.25 / torch.clamp(total / sum(v.numel() for v in nhwc), min=1e-9)
            for band, y in zip(bands, linear):
                if scale is None:
                    z = (y - bottom.to(y.device)) / torch.clamp(top_p.to(y.device), min=1e-9)
                else:
                    z = y * scale.to(y.device)
                out[2 * band.start:2 * band.stop] = core.tone(z)[0].permute(1, 2, 0).cpu()
    return out


def develop_image(model, stack, devices, report=None):
    """The JAX CLI's ``--devices`` development of a (h, w, 4) stack: its
    height reflect-padded to a multiple of the band count, developed in
    bands (:func:`develop_bands`), cropped to (2h, 2w, 3)."""
    h = stack.shape[0]
    return develop_bands(model, pad_rows(stack, len(devices)), devices, report)[:2 * h]
