"""
Starting the ranks of a data-parallel run on this host.

``run(fn, devices)`` runs ``fn(parallel, *args)`` in one process per entry
of ``devices`` (rank r on ``devices[r]``), joined over TCP on 127.0.0.1,
and returns each rank's result; the library's way to run ranks, and the
only one that puts two ranks on one card (``backend='gloo'``).
``run_cli(module, argv, n, device)`` is a CLI's ``--devices n``: it starts
the CLI module once per rank with ``--coordinator/--nproc/--procid`` and
this rank's ``--device`` appended, and waits for all of them. Rank 0 is the
primary, which writes the files.

Both wait with a deadline where one is given and stop every process they
started, whatever happens.
"""
import multiprocessing
import pickle
import queue
import subprocess
import sys
import time
import traceback

import torch

from neural_imaging_tpu_torch.parallel import multihost
from neural_imaging_tpu_torch.parallel.mesh import make_mesh
from neural_imaging_tpu_torch.parallel.train import DataParallel, resolve_count


def rank_devices(device, n):
    """The devices of ``n`` ranks of a CLI's ``--devices n``: the CPU for
    each on 'cpu', the first n cards on 'cuda'."""
    device = torch.device(device)
    if device.type == 'cpu':
        return ['cpu'] * n
    if device.index is not None and n > 1:
        raise ValueError(f'--device {device} names one card; --devices {n} takes the first '
                         f'{n} cards with --device cuda')
    if n > torch.cuda.device_count():
        raise ValueError(f'--devices {n} asks for {n} CUDA devices; this machine has '
                         f'{torch.cuda.device_count()}')
    return [f'cuda:{i}' for i in range(n)]


def _to_host(obj):
    """``obj`` with every tensor copied to the CPU (results cross processes)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, devices, backend, port, args, results, threads, timeout_s):
    try:
        if threads:
            torch.set_num_threads(threads)
        multihost.initialize(f'127.0.0.1:{port}', len(devices), rank, device=devices[rank],
                             backend=backend, timeout_s=timeout_s)
        out = fn(DataParallel(make_mesh(devices[rank])), *args)
        # pickled here: a tensor put on the queue as it is would be shared
        # through memory that dies with this process
        results.put((rank, 'ok', pickle.dumps(_to_host(out))))
    except BaseException:  # noqa: B902 - reported to the launcher, which raises it
        results.put((rank, 'error', traceback.format_exc()))
    finally:
        multihost.shutdown()


def run(fn, devices, args=(), backend=None, timeout_s=60, threads=None):
    """Run ``fn(parallel, *args)`` on ``len(devices)`` ranks, rank r in a
    process of its own on ``devices[r]`` (a module-level function: the
    processes are spawned). ``backend``: None takes NCCL for cards and gloo
    for the CPU; 'gloo' lets ranks share a card. ``threads`` sets each
    rank's CPU thread count. Returns the ranks' results, in rank order, with
    their tensors on the CPU; raises if a rank fails or the ranks do not all
    finish within ``timeout_s`` seconds (and then stops them all)."""
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    port = multihost.free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, list(devices), backend, port, tuple(args), results,
                               threads, timeout_s))
             for r in range(len(devices))]
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < len(procs):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f'{len(procs)} ranks did not finish within {timeout_s} s '
                                   f'(finished: {sorted(got)})')
            try:
                rank, status, payload = results.get(timeout=min(remaining, 0.5))
            except queue.Empty:
                lost = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in
                        (None, 0)]
                if lost:
                    raise RuntimeError(f'rank {lost[0]} exited with code '
                                       f'{procs[lost[0]].exitcode} without a result')
                continue
            if status == 'error':
                raise RuntimeError(f'rank {rank} failed:\n{payload}')
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return [got[r] for r in range(len(procs))]


def run_cli(module, argv, n, device, env=None):
    """A CLI's ``--devices n``: start ``python -m module argv`` once per rank
    with the rank's flags appended, on ``rank_devices(device, n)``, and wait
    for all of them. Raises if a rank fails (after stopping the others)."""
    devices = rank_devices(device, n)
    port = multihost.free_port()
    procs = []
    try:
        for r, dev in enumerate(devices):
            procs.append(subprocess.Popen(
                [sys.executable, '-m', module, *argv, '--coordinator', f'127.0.0.1:{port}',
                 '--nproc', str(n), '--procid', str(r), '--device', dev],
                env=env or multihost.rank_environment()))
        pending = list(range(n))
        while pending:
            for r in list(pending):
                code = procs[r].poll()
                if code is None:
                    continue
                pending.remove(r)
                if code != 0:
                    raise RuntimeError(f'rank {r} of {n} exited with code {code}')
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def launch_cli_ranks(module, argv, args, batch_size):
    """A trainer CLI's ``--devices n`` without ``--coordinator``: start its n
    ranks (``run_cli``) and wait for them; True when it did. False, with
    nothing started, where one process trains (no ``--devices``, one
    device, or this process being one rank of a group)."""
    if args.coordinator is not None or args.nproc is not None or args.procid is not None:
        return False
    n = resolve_count(args.devices, batch_size, args.device)
    if n <= 1:
        return False
    run_cli(module, list(sys.argv[1:] if argv is None else argv), n, args.device)
    return True
