#!/usr/bin/env python3
"""
A cell read through the program's own spans and counters
(``neural_imaging_tpu_torch.utils.profiling``; the attribution is
``benchmark/spans.py``'s):

    python3 benchmark/tools/span_report.py --workload <cell> --seed <n> \\
        [--calls 30] [--windows 6] [--seconds 5] [--out DIR]

1. Set-up with the program's tracing on: ``build_s``, the host seconds in
   the spans 'build' and 'kernels.load'.
2. The cost of tracing: windows of ``--seconds`` in turns with the
   program's tracing off and on (``run.measure``, the benchmark's window),
   ``samples_per_s`` of each; the spans recorded a call; a span's host cost
   on and off, timed alone.
3. ``--calls`` calls under a trace of the device alone, the spans recorded
   beside it: the idle time by span (``idle by span`` on stderr) against the
   window's idle share; the 'Memcpy HtoD' operations a call against the
   host→device copies the program counted in the same calls, and their GB/s.
4. ``--calls`` calls under a trace of the host and the device: device ms a
   call by span (a stage's backward with its forward) and the share the
   spans hold; the operator and span that launched each 'Memcpy HtoD', and
   the operators behind the time left in a root span, 'backward' or none.

Needs a CUDA device. Prints one JSON line, and writes it to ``<out>/<cell>.json`` with ``--out``.
"""
import argparse
import collections
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark import run, spans, trace  # noqa: E402


def span_cost_us(profiling, n=100_000):
    """Host µs of an empty span, recording off and on."""
    out = {}
    for on in (False, True):
        profiling.tracing(on)
        t = time.perf_counter()
        for _ in range(n):
            with profiling.span('cost'):
                pass
        out['on' if on else 'off'] = 1e6 * (time.perf_counter() - t) / n
    profiling.tracing(False)
    profiling.clear()
    return out


def windows(entry, state, profiling, n, seconds, marks):
    """``samples_per_s`` of ``n`` windows in turns, tracing off then on, and
    the spans recorded a call with it on."""
    rates, per_call = {'off': [], 'on': []}, []
    for i in range(2 * n):
        on = i % 2 == 1
        profiling.clear()
        profiling.tracing(on)
        w = run.measure(entry, state, seconds, marks)
        profiling.tracing(False)
        rates['on' if on else 'off'].append(state.samples * w['n_calls'] / w['window_s'])
        if on:
            per_call.append(len(profiling.spans()) / w['n_calls'])
    profiling.clear()
    return rates, statistics.mean(per_call)


def report(workload, seed, calls, n_windows, seconds, device, overrides=None):
    """The report of a cell as a dict; ``overrides`` as ``run.run`` takes them."""
    from neural_imaging_tpu_torch.utils import profiling
    _, _, spec, config = run.cell(workload)
    spec = run.merge(spec, (overrides or {}).get('workload'))
    config = run.merge(config, (overrides or {}).get('config'))
    entry = importlib.import_module(f"benchmark.entries.{spec['entry']}")
    torch.manual_seed(int(seed))
    profiling.clear()
    profiling.tracing(True)
    t = time.perf_counter()
    state = entry.setup(config, spec, seed, device)
    setup_s = time.perf_counter() - t
    profiling.tracing(False)
    built = [r for r in profiling.spans() if r['name'] in ('build', 'kernels.load')]
    ids = {r['id'] for r in built}
    build_s = sum(r['end'] - r['start'] for r in built if r['parent'] not in ids) / 1e9
    out = {'cell': workload, 'seed': seed, 'setup_s': setup_s, 'build_s': build_s,
           'build_spans': {r['name']: (r['end'] - r['start']) / 1e9 for r in built}}
    marks = run.Marks(device)
    rates, spans_a_call = windows(entry, state, profiling, n_windows, seconds, marks)
    off, on = statistics.median(rates['off']), statistics.median(rates['on'])
    out.update(samples_per_s=rates, tracing_cost_pct=100 * (off - on) / off,
               spans_per_call=spans_a_call, span_us=span_cost_us(profiling))

    # the device alone, the spans beside it
    torch.cuda.synchronize(device)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(calls):
            entry.call(state)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(device)
    records = profiling.spans()
    timeline = trace.Trace(prof.profiler.kineto_results.events(), calls)
    program = spans.program_calls(0, float('inf'))
    out['device_only'] = {
        'h2d_copies_per_call': sum(c for c, _ in program) / len(program),
        'h2d_bytes_per_call': sum(b for _, b in program) / len(program)}
    if timeline.ops:
        idle = spans.idle_by_span(timeline, records)
        htod_ops, htod_s = spans.htod_per_call(timeline)
        n_bytes = out['device_only']['h2d_bytes_per_call']
        out['device_only'].update(
            window_s=timeline.window_s, busy_s=timeline.busy_s,
            idle_pct=100 * (1 - timeline.busy_s / timeline.window_s),
            idle_by_span_ms_a_call={k: 1e3 * v / calls for k, v in sorted(idle.items())},
            idle_by_span_pct_sum=100 * sum(idle.values()) / timeline.window_s,
            htod_ops_per_call=htod_ops, htod_ms_per_call=1e3 * htod_s,
            h2d_gbps=n_bytes / htod_s / 1e9 if htod_s > 0 else None)
        print(f'idle by span [{workload}]: ' + ', '.join(
            f'{k} {1e3 * v:.3f} ms' for k, v in sorted(idle.items(), key=lambda kv: -kv[1]))
            + f' over {calls} calls; idle {100 * sum(idle.values()) / timeline.window_s:.2f}%'
            f' of the window, device_idle_pct {out["device_only"]["idle_pct"]:.2f}',
            file=sys.stderr, flush=True)

    # the host and the device
    torch.cuda.synchronize(device)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            entry.call(state)
        torch.cuda.synchronize(device)
    profiling.clear()
    ops = spans.attribute(prof.profiler.kineto_results.events())
    ms, sites, direct = collections.Counter(), collections.Counter(), collections.Counter()
    for name, ns, span, host in ops:
        ms[span] += ns / 1e6 / calls
        if name.startswith(spans.HTOD):
            sites[f'{span}: {host}'] += 1 / calls
        if span in spans.ROOTS + ('backward', spans.OUTSIDE):
            direct[f'{span}: {host}'] += ns / 1e6 / calls
    total = sum(ms.values())
    out['host_device'] = {
        'device_ms_by_span': dict(sorted(ms.items(), key=lambda kv: -kv[1])),
        'spans_share_pct': (100 * (total - ms.get(spans.OUTSIDE, 0.0)) / total
                            if total else None),
        'htod_sites_per_call': dict(sites),
        'roots_backward_outside_by_operator': dict(direct.most_common(8))}
    entry.close(state)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--calls', type=int, default=30)
    p.add_argument('--windows', type=int, default=6)
    p.add_argument('--seconds', type=float, default=5.0)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    out = report(args.workload, args.seed, args.calls, args.windows, args.seconds,
                 torch.device('cuda'))
    line = json.dumps(out)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f'{args.workload}.json').write_text(line + '\n')
    print(line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
