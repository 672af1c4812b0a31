#!/usr/bin/env python3
"""
The benchmark of the PyTorch and CUDA port (``neural_imaging_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one cell of ``BENCHMARK.json``, once: set-up (the program's
kernels built or reused in its checkout, weights and inputs made from the
seed, the cell's shapes warmed up), a measured window of ``--seconds``, the
judgement against the plain reference, and one JSON line as the last line of
standard output. ``--trace 1`` adds a traced part after the window and
prints the cell's per-layer metrics instead of its end-to-end ones. A
``--trace 0`` run whose end-to-end metrics read the device's busy time (a
reader with ``TRACED = True``) traces the device alone over the cell's
traced calls after the window, outside ``setup_s``.

Everything is found by name: the cell in ``workloads/<cell>.json`` (its
entry, warm-up, traced calls and the limits of its numbers), its traffic
mix in ``traffic/<traffic>.json`` (read by ``generator.py``), its
configuration in ``configs/<config>.json``, the entry the window drives in
``entries/<entry>.py``, each metric's reader in ``metrics/<metric>.py`` (the
metric's name up to its first dot).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / 'benchmark'
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / '.bench_cache'
os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(CACHE / 'torch_extensions'))
os.environ.setdefault('TRITON_CACHE_DIR', str(CACHE / 'triton'))
os.environ['USE_FLAX'] = '0'

import numpy as np  # noqa: E402
import torch  # noqa: E402

# modules that nothing the benchmark runs may load, by whole top-level name
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'neural_imaging_tpu')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def merge(base, extra):
    """``base`` with the entries of ``extra`` laid over it, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell(workload, manifest=None):
    """(manifest, the cell's manifest entry, its workload file, its configuration file)."""
    manifest = manifest or load_json(ROOT / 'BENCHMARK.json')
    entry = next((w for w in manifest['workloads'] if w['name'] == workload), None)
    if entry is None:
        raise SystemExit(f'unknown workload {workload!r}')
    spec = load_json(BENCH / 'workloads' / f'{workload}.json')
    spec['traffic'] = load_json(BENCH / 'traffic' / f"{entry['traffic']}.json")
    config = load_json(BENCH / 'configs' / f"{entry['config']}.json")
    return manifest, entry, spec, config


def metrics_of(manifest, kind, workload):
    return [m for m in manifest[kind] if workload in m.get('workloads', [workload])]


def reader_of(metric):
    """The reader module of a metric: its name up to the first dot. The part
    after the dot names the cells whose end-to-end metric it moves
    ('fan_ms.train', 'fan_ms.classify'): one quantity, one reader."""
    return metric.split('.')[0]


class Marks:
    """Stream marks for call times: CUDA events on the card, the host clock
    elsewhere (a rehearsal on the CPU)."""

    def __init__(self, device):
        self.cuda = device.type == 'cuda'

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def measure(entry, state, seconds, marks):
    """Calls back to back until ``seconds`` have passed on the host clock;
    the window ends at a synchronize after the last call. A call's latency
    runs from the stream mark recorded before it to the next one (the
    last: to the window's closing mark), so the host's queueing ahead is
    kept and any idle gap it causes is counted."""
    marks.sync()
    starts, dispatch_ms = [], []
    t0 = time.perf_counter()
    while True:
        starts.append(marks.mark())
        h = time.perf_counter()
        entry.call(state)
        now = time.perf_counter()
        dispatch_ms.append(1e3 * (now - h))
        if now - t0 >= seconds:
            break
    closing = marks.mark()
    marks.sync()
    window_s = time.perf_counter() - t0
    latencies = [marks.ms(a, b) for a, b in zip(starts, starts[1:] + [closing])]
    return {'window_s': window_s, 'latencies_ms': latencies, 'dispatch_ms': dispatch_ms,
            'n_calls': len(starts)}


def program_counters():
    """{kernel: Counter of launches by shape} of the program's K1-K4 launchers."""
    from neural_imaging_tpu_torch.ops.hopper import codebook, jpeg8x8
    return {'k1': jpeg8x8.jpeg_core_cuda.sizes, 'k2': codebook.codebook_fwd_cuda.sizes,
            'k3': codebook.codebook_bwd_cuda.sizes, 'k4': codebook.codebook_bwd_train_cuda.sizes}


def layers_of(flow, config):
    def get(path):
        obj = flow
        for part in path.split('.'):
            obj = getattr(obj, part)
        return obj
    return {name: (get(first), get(last)) for name, (first, last) in config['layers'].items()}


class Context:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.trace = None
        self.timeline = None
        self.kernel_ms = None
        self.dispatch_ms = []
        self.launches = {}
        self.reference_flops = None
        self.peaks = None
        self.codes = 32
        self.__dict__.update(kw)


def count_flops(fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def run(workload, seed, seconds, trace, device='cuda', overrides=None, tamper=None,
        manifest=None, keep=None):
    """One run of a cell; returns its result line as a dict. ``overrides``
    ({'config': ..., 'workload': ...}) are laid over the cell's files (the
    tests' tiny sizes); ``tamper(flow)`` runs once the program is built (the
    tests' planted faults); ``keep``, a dict, receives the readers' context
    and the judgement's numbers."""
    from benchmark import judge, work
    from benchmark.reference import ops as ref_ops
    device = torch.device(device)
    manifest, _, spec, config = cell(workload, manifest)
    spec = merge(spec, (overrides or {}).get('workload'))
    config = merge(config, (overrides or {}).get('config'))
    entry = importlib.import_module(f"benchmark.entries.{spec['entry']}")
    torch.manual_seed(int(seed))
    t_entry = time.perf_counter()
    state = entry.setup(config, spec, seed, device, tamper=tamper)
    marks = Marks(device)
    marks.sync()
    setup_s = time.perf_counter() - T_START
    window = measure(entry, state, seconds, marks)
    failed = entry.close(state)
    failed = window['n_calls'] if failed is None else failed
    peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0
    name = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    ctx = Context(setup_s=setup_s, samples=state.samples, peaks=work.PEAKS.get(name),
                  codes=2 ** config.get('codec', {}).get('latent_bpf', 5), **window)
    if keep is not None:
        keep['ctx'] = ctx
    kind = 'per_layer' if trace else 'end_to_end'
    readers = {m['name']: importlib.import_module(f"benchmark.metrics.{reader_of(m['name'])}")
               for m in metrics_of(manifest, kind, workload)}
    if not trace and any(getattr(r, 'TRACED', False) for r in readers.values()):
        from benchmark import trace as trace_mod
        ctx.timeline = trace_mod.device_only_calls(entry, state, spec['trace_calls'], device)
        if entry.close(state) is None:
            failed = window['n_calls']
    if trace:
        from benchmark import kernel_timing, trace as trace_mod
        counters = program_counters()
        before = {k: c.copy() for k, c in counters.items()}
        ctx.timeline, ctx.trace = trace_mod.traced_calls(
            entry, state, spec['trace_calls'], layers_of(state.flow, config), device)
        ctx.launches = {k: c - before[k] for k, c in counters.items()}
        if entry.close(state) is None:
            failed = window['n_calls']
        if device.type == 'cuda':
            ctx.kernel_ms = kernel_timing.kernel_ms(ctx.launches, ctx.codes, device, seed)
    prog = entry.program_side(state)
    entry.free(state)
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    with ref_ops.precision(False):
        ref = entry.reference_side(state)
        numbers = entry.numbers(prog, ref)
        if trace:
            ctx.reference_flops = count_flops(lambda: entry.reference_call(state))
    checks, within, missing = judge.verdict(numbers, spec['limits'])
    if keep is not None:
        keep['numbers'] = numbers
    metrics = {}
    for m in metrics_of(manifest, kind, workload):
        value = readers[m['name']].read(ctx)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    result = {'correct': bool(within and failed == 0), 'attempted': window['n_calls'],
              'failed': failed, 'metrics': metrics,
              'device': {'platform': 'gpu' if device.type == 'cuda' else device.type,
                         'kind': name, 'count': 1, 'memory_peak_bytes': int(peak)}}
    if trace and ctx.timeline is not None:
        result['device'].update(busy_s=ctx.timeline.busy_s, window_s=ctx.timeline.window_s)
        result['breakdown'] = {'device_ops': ctx.timeline.top_ops(),
                               'idle_gaps': ctx.trace.top_gaps()}
    lat = np.asarray(window['latencies_ms'])
    print(f"[{workload}] seed {seed}: {window['n_calls']} calls in {window['window_s']:.3f} s, "
          f"latency median {np.median(lat):.4f} ms p95 {np.percentile(lat, 95):.4f} ms over "
          f"{lat.size} calls; set-up {setup_s:.3f} s ({t_entry - T_START:.3f} before the "
          f"entry's set-up, then {', '.join(f'{k} {v:.3f}' for k, v in state.phases.items())})"
          f"; peak {peak} bytes; numbers {numbers}",
          file=sys.stderr, flush=True)
    if missing:
        print(f'numbers missing: {missing}', file=sys.stderr, flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    result['checks'] = checks
    return result


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (the loaded modules')."""
    return sorted({m.split('.')[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    manifest, entry, _, _ = cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry['chips']:
        print(f"no result: the cell needs {entry['chips']} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    result = run(args.workload, args.seed, args.seconds, args.trace, 'cuda', manifest=manifest)
    found = forbidden_modules()
    if found:
        print(f'no result: the process loaded {found}', file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
