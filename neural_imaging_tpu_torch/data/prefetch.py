"""
Host → device batch prefetching: port of ``neural_imaging_tpu/data/prefetch.py``.

A producer thread samples the next batches on the host (numpy, quantized)
and copies them to the device while the device runs the current step. For
a CUDA device each batch goes through freshly allocated pinned memory and a
``non_blocking`` copy; PyTorch's pinned-memory allocator does not hand a
buffer out again before the copies queued from it have run, so no batch
overwrites one still in flight. The copies are queued on the current
stream, ahead of the steps that read them.
"""
import queue
import threading

import torch

_SENTINEL = object()


def to_device(batch, device):
    """A numpy batch (an array or a tuple of arrays, None kept) as tensors on
    ``device``: through pinned memory and a non-blocking copy for CUDA."""
    if isinstance(batch, tuple):
        return tuple(None if b is None else to_device(b, device) for b in batch)
    t = torch.from_numpy(batch)
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch(generator, device, size=2):
    """Iterate ``generator``'s numpy batches as tensors on ``device``, made
    and copied ``size`` batches ahead by a background thread. An exception
    of the producer is raised here, after the batches made before it. A
    consumer that stops early (``break``, an exception, ``close()``) stops
    the producer at its next batch."""
    q = queue.Queue(maxsize=size)
    stop = threading.Event()
    error = []

    def put(item):
        """Queue ``item``; False, without queuing it, once the consumer stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for batch in generator:
                if not put(to_device(batch, device)):
                    return
        except Exception as e:  # handed to the consumer below
            error.append(e)
        finally:
            put(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
    finally:
        stop.set()
        thread.join()
    if error:
        raise error[0]


class EpochPrefetcher:
    """Reusable per-epoch prefetcher over a Dataset's training batches,
    quantized (uint16 RAW / uint8 RGB; the flow normalizes them). With
    ``parallel`` (a ``DataParallel``), every rank samples the global batch
    from its own copy of the dataset (the same draws on every rank) and puts
    only its rows on its device."""

    def __init__(self, data, batch_size, rgb_patch_size, device, discard='flat',
                 parallel=None):
        self.data = data
        self.batch_size = batch_size
        self.rgb_patch_size = rgb_patch_size
        self.device = torch.device(device)
        self.discard = discard
        self.parallel = parallel
        if parallel is not None:
            parallel.check_batch(batch_size)

    def __iter__(self):
        gen = self.data.get_training_generator(self.batch_size, self.rgb_patch_size,
                                               self.discard, quantized=True)
        if self.parallel is not None:
            gen = (self.parallel.shard(*b) if isinstance(b, tuple) else self.parallel.shard(b)[0]
                   for b in gen)
        return prefetch(gen, self.device)
