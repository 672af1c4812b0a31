"""
Memory and device diagnostics: port of
``neural_imaging_tpu/utils/debugging.py``. The host's RSS probes are copied;
the device's memory comes from PyTorch's CUDA caching allocator, and the
live device tensors are found through the garbage collector.
"""
import gc
import os
import resource
import warnings

import numpy as np
import torch


def memory_usage_resource():
    """Peak RSS of the current process in MB (via getrusage)."""
    rusage = resource.getrusage(resource.RUSAGE_SELF)
    return rusage.ru_maxrss / 1024.0


def memory_usage_proc():
    """Current RSS in MB (via /proc/self/status)."""
    try:
        with open('/proc/self/status') as f:
            for line in f:
                if line.startswith('VmRSS:'):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return float('nan')


def memory_usage_psutil():
    try:
        import psutil
        return psutil.Process(os.getpid()).memory_info().rss / 1024.0 / 1024.0
    except ImportError:
        return memory_usage_proc()


def array_megabytes(arr):
    """Size of a numpy array or a tensor in MB."""
    if torch.is_tensor(arr):
        return arr.numel() * arr.element_size() / 1024.0 / 1024.0
    arr = np.asarray(arr) if not hasattr(arr, 'nbytes') else arr
    return arr.nbytes / 1024.0 / 1024.0


def device_memory_stats():
    """{device name: ``torch.cuda.memory_stats``} for every CUDA device; empty
    without one (the CPU has no allocator statistics)."""
    if not torch.cuda.is_available():
        return {}
    return {str(torch.device('cuda', i)): torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def live_device_arrays():
    """{device name: (count, MB)} of the live CUDA tensors that the garbage
    collector tracks (parameters and tensors held by Python objects; views
    count with their own sizes)."""
    totals = {}
    with warnings.catch_warnings():
        # some objects warn when their type is inspected (deprecated aliases)
        warnings.simplefilter('ignore')
        tensors = [obj for obj in gc.get_objects() if torch.is_tensor(obj)]
    for obj in tensors:
        if not obj.is_cuda:
            continue
        key = str(obj.device)
        count, mb = totals.get(key, (0, 0.0))
        totals[key] = (count + 1, mb + array_megabytes(obj))
    return totals
