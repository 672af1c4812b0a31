"""
Runtime helpers: port of ``fetch_with_timeout`` of
``neural_imaging_tpu/utils/runtime.py``.

The rest of that module configures JAX or XLA and has no counterpart here:
``configure_jax`` (JAX's platform and its persistent compilation cache),
``maybe_jit`` (PyTorch runs eagerly; nothing is compiled), and
``warn_if_uncalibrated_device`` with ``CALIBRATED_DEVICE_KIND`` (the TPU
generation that the JAX package's 'auto' crossovers were measured on).
"""
import threading

import numpy as np
import torch


def fetch_with_timeout(arr, timeout_s=15.0):
    """Device→host copy guarded by a deadline: the numpy value of ``arr`` (a
    tensor, on any device, or anything ``np.asarray`` takes), or None if the
    copy has not finished after ``timeout_s`` seconds.

    The copy runs in a daemon thread, so a stalled device cannot hang the
    caller; the thread is left behind on a timeout."""
    out = {}

    def pull():
        out['v'] = arr.detach().cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)

    t = threading.Thread(target=pull, daemon=True)
    t.start()
    t.join(timeout_s)
    return out.get('v')
