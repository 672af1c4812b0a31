"""How often a scenario of ``config/tests/framework.json`` meets its gate,
and how busy it keeps the card (the numbers in PERF.md's findings on the
framework harness).

    # train-dcn 20 times through the port's CLI on the card
    python tests/support/framework_spread.py train-dcn --runs 20 --root /tmp/spread
    # the JAX package's train-dcn through its harness, on the CPU
    JAX_PLATFORMS=cpu python tests/support/framework_spread.py train-dcn \\
        --package jax --runs 3 --root /tmp/spread
    # one run under torch.profiler: the card's busy share of its wall time
    python tests/support/framework_spread.py train-dcn --profile --root /tmp/spread
    # train-dcn in both packages with the augmentations drawn alike (the CPU)
    JAX_PLATFORMS=cpu python tests/support/framework_spread.py train-dcn \
        --matched 1,2,3 --device cpu --root /tmp/spread

A run is the scenario as the spec and the harness give it, unseeded as the
harness runs it: the port's CLI ``main`` called in this process on the
harness's mapped argv (``--device`` appended), or the JAX harness's
``run_scenario``, a subprocess. The scenarios it depends on run once
first, where their artifacts are missing. Only a scenario that starts
afresh (``--overwrite``) is run more than once. Each run prints one ``RESULT``
line (its seconds and gate values); the last line counts the misses.
``--matched SEEDS`` runs train-dcn's trainer in each package instead, on
the spec's settings (its command parsed by the port CLI's parser, each
package's codec, ``Dataset`` and ``train_dcn`` as its CLI calls them) with
the augmentations drawn from one ``np.random.default_rng(seed)`` in both:
the two runs then see the same weights, patches and augmentations, and
each prints one ``MATCHED`` line. JAX is imported only with ``--package
jax`` and ``--matched``."""
import argparse
import importlib
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from neural_imaging_tpu_torch.cli import test_framework as harness  # noqa: E402
from neural_imaging_tpu_torch.utils.device import resolve_device  # noqa: E402


def run_in_process(module, argv):
    importlib.import_module(module).main(argv)
    return 0, ''


def port_run(name, spec, root, cam, device):
    ok, message, _ = harness.run_scenario(name, spec, root, cam, device, run=run_in_process)
    return ok, message


def jax_run(name, spec, root, cam, device):
    import test_framework as jax_harness
    return jax_harness.run_scenario(name, spec, root, cam, platform='cpu')


def profile_run(name, spec, root, cam, device):
    """One run under ``torch.profiler``; prints the card's busy time and
    share of the run's wall time and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ok, message = port_run(name, spec, root, cam, device)
        if device == 'cuda':
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f'PROFILE {name}: wall {wall:.2f} s, device {busy:.2f} s, busy {100 * busy / wall:.1f}%, '
          f'{sum(e.count for e in events)} device ops', flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f'PROFILE   {e.self_device_time_total / 1e6:8.3f} s x{e.count:7d} {e.key[:90]}',
              flush=True)
    return ok, message


def matched_runs(spec, root, cam, device, seeds):
    """train-dcn's trainer in both packages from one augmentation seed."""
    import json
    import numpy as np
    from neural_imaging_tpu.data.dataset import Dataset as JaxDataset
    from neural_imaging_tpu.models import compression as jcompression
    from neural_imaging_tpu.training.compression import train_dcn as jax_train_dcn
    from neural_imaging_tpu_torch.cli import train_dcn as cli
    from neural_imaging_tpu_torch.data.dataset import Dataset
    from neural_imaging_tpu_torch.models import compression
    from neural_imaging_tpu_torch.training.compression import train_dcn
    module, argv = harness.port_command(spec['command'], root, cam, device)
    if module != cli.__name__:
        raise SystemExit(f'--matched runs train_dcn scenarios, not {module}')
    args = cli.build_parser().parse_args(argv)
    n_images, v_images, val_n_patches = cli.parse_split(args.split)
    split = dict(load='y', n_images=n_images, v_images=v_images,
                 val_rgb_patch_size=args.patch, val_n_patches=val_n_patches)
    training = {'n_epochs': args.epochs, 'batch_size': args.batch, 'patch_size': args.patch,
                'learning_rate': args.lr, 'validation_schedule': args.val_schedule}
    params = cli.parse_json_arg(args.params)
    for seed in seeds:
        for package in ('jax', 'port'):
            out = os.path.join(root, 'matched', f'{package}-{seed}')
            if package == 'jax':
                directory = jax_train_dcn(
                    getattr(jcompression, args.dcn)(patch_size=args.patch, **params),
                    dict(training), JaxDataset(args.data, **split), directory=out,
                    overwrite=True, rng=np.random.default_rng(seed))
            else:
                directory = train_dcn(
                    getattr(compression, args.dcn)(patch_size=args.patch, device=device,
                                                   **params),
                    dict(training), Dataset(args.data, **split), directory=out,
                    overwrite=True, rng=np.random.default_rng(seed))
            with open(os.path.join(directory, 'progress.json')) as f:
                perf = json.load(f)['codec']['performance']
            tail = slice(-(len(perf['loss']['training']) // 4), None)
            print('MATCHED', package, 'seed', seed, 'loss last quarter',
                  round(float(np.mean(perf['loss']['training'][tail])), 4), 'entropy',
                  round(float(np.mean(perf['entropy']['training'][tail])), 4), 'ssim',
                  round(perf['ssim']['validation'][-1], 4), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('scenario')
    parser.add_argument('--runs', type=int, default=1)
    parser.add_argument('--package', default='port', choices=['port', 'jax'])
    parser.add_argument('--device', default='cuda', help="the port's: 'cuda' (default) or 'cpu'")
    parser.add_argument('--profile', action='store_true', help='one port run, profiled')
    parser.add_argument('--matched', default=None, help='train-dcn: seeds, both packages')
    parser.add_argument('--root', required=True)
    args = parser.parse_args(argv)
    scenarios = harness.load_spec()
    if args.runs > 1 and '--overwrite' not in scenarios[args.scenario]['command']:
        parser.error(f'{args.scenario} continues its last run: it can be run once')
    cam = harness.DEFAULT_CAM
    if args.package == 'port':
        resolve_device(args.device)
    os.makedirs(args.root, exist_ok=True)
    harness.prepare_data(args.root, cam)
    if args.matched:
        return matched_runs(scenarios[args.scenario], args.root, cam, args.device,
                            [int(seed) for seed in args.matched.split(',')])
    run = jax_run if args.package == 'jax' else port_run
    for dep in harness.DEPENDENCIES.get(args.scenario, ()):
        if harness.missing_artifacts(scenarios[dep], args.root, cam):
            ok, message = run(dep, scenarios[dep], args.root, cam, args.device)
            if not ok:
                raise RuntimeError(f'{dep}: {message}')
    if args.profile:
        run, args.runs = profile_run, 1
    spec, misses = scenarios[args.scenario], 0
    for i in range(args.runs):
        t0 = time.perf_counter()
        ok, message = run(args.scenario, spec, args.root, cam, args.device)
        seconds = time.perf_counter() - t0
        values = (harness.gate_values(spec, args.root, cam)
                  if not harness.missing_artifacts(spec, args.root, cam) else {})
        misses += not ok
        print('RESULT', args.package, args.scenario, i, f'{seconds:.1f} s',
              'PASS' if ok else 'MISS', {k: v for k, (v, _) in values.items()}, message,
              flush=True)
    print(f'SPREAD {args.package} {args.scenario}: {misses} of {args.runs} runs missed the gate',
          flush=True)


if __name__ == '__main__':
    main()
