"""
The end-to-end framework harness of the PyTorch port: the counterpart of the
repository's ``test_framework.py``. It runs every scenario of
``config/tests/framework.json`` through the port's own CLIs and holds each
to the spec's artifact list and metric gates.

    python -m neural_imaging_tpu_torch.cli.test_framework [--fresh] \\
        [--scenario NAME] [--device cuda|cpu] [--root DIR]

The spec is read, not copied: each command ``python3 {repo}/<name>.py ...``
runs as ``python3 -m neural_imaging_tpu_torch.cli.<name> ... --device
<device>`` with its flags unchanged (a script with no port CLI raises,
naming it). Fixture data is made as the JAX harness makes it: 8 RAW/RGB
pairs of 192x256 from seed 1000 under ``<root>/data/<cam>`` and 18 RGB
images from seed 2000 under ``<root>/data/rgb``. The scratch root defaults
to ``neural-imaging-tpu-torch`` in the temporary directory, apart from the
JAX harness's, since scenarios resume or load earlier scenarios' runs.

A scenario passes when its command exits 0, every listed artifact exists
and the last logged value of each gate key is at least its threshold (a NaN
fails). Scenarios run in the spec's order; one whose prerequisite failed is
skipped. Each prints its wall seconds, as does the summary table; the
exit code is 1 if any scenario did not pass.
``--device`` defaults to ``cuda``: without a card the harness refuses to
run, and the CPU must be asked for.
"""
import argparse
import importlib.util
import json
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from neural_imaging_tpu_torch.utils.device import resolve_device
from neural_imaging_tpu_torch.utils.utils import get, setup_logging

REPO = str(Path(__file__).resolve().parents[2])
SPEC = os.path.join(REPO, 'config', 'tests', 'framework.json')
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), 'neural-imaging-tpu-torch')
DEFAULT_CAM = 'SyntheticCam'
CLI_PACKAGE = 'neural_imaging_tpu_torch.cli'
# scenarios that resume or load the run of another
DEPENDENCIES = {'resume-nip': ('train-nip',),
                'train-manipulation': ('train-nip',),
                'train-manipulation-bf16': ('train-nip',),
                'train-manipulation-dcn': ('train-dcn',)}


def load_spec(path=SPEC):
    """The scenarios of a spec file, in its order."""
    with open(path) as f:
        return json.load(f)


def prepare_data(root, cam):
    """The JAX harness's fixture directories under ``<root>/data``, made once."""
    from neural_imaging_tpu_torch.data import fixtures
    raw_dir = os.path.join(root, 'data', cam)
    rgb_dir = os.path.join(root, 'data', 'rgb')
    if not os.path.isdir(raw_dir) or not os.listdir(raw_dir):
        fixtures.make_dataset(raw_dir, n_images=8, height=192, width=256, seed=1000)
    if not os.path.isdir(rgb_dir) or not os.listdir(rgb_dir):
        fixtures.make_dataset(rgb_dir, n_images=18, height=192, width=256, seed=2000,
                              rgb_only=True)


def port_command(command, root, cam, device):
    """A spec command as (port CLI module, its argv): ``python3 <dir>/<name>.py
    flags...`` → (``neural_imaging_tpu_torch.cli.<name>``, flags + ``--device``)."""
    tokens = shlex.split(command.format(root=root, cam=cam, repo=REPO))
    if (len(tokens) < 2 or not os.path.basename(tokens[0]).startswith('python')
            or not tokens[1].endswith('.py')):
        raise ValueError(f'not a Python script command: {command}')
    script = os.path.basename(tokens[1])[:-len('.py')]
    module = f'{CLI_PACKAGE}.{script}'
    if importlib.util.find_spec(module) is None:
        raise ValueError(f'{script}.py has no port CLI (no module {module})')
    return module, tokens[2:] + ['--device', device]


def run_subprocess(module, argv):
    """Run a port CLI in its own process from the repository root; returns
    (exit code, its output)."""
    proc = subprocess.run([sys.executable, '-m', module, *argv], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, cwd=REPO)
    return proc.returncode, proc.stdout


def missing_artifacts(spec, root, cam):
    """The spec's artifact paths that do not exist."""
    paths = [os.path.join(root, rel.format(root=root, cam=cam)) for rel in spec.get('files', [])]
    return [path for path in paths if not os.path.isfile(path)]


def gate_values(spec, root, cam):
    """{gate key: (the last logged value, its threshold)}."""
    perf = spec.get('performance')
    if not perf:
        return {}
    with open(os.path.join(root, perf['file'].format(root=root, cam=cam))) as f:
        log = json.load(f)
    values = {}
    for key, threshold in perf['values'].items():
        value = get(log, key)
        values[key] = (value[-1] if isinstance(value, list) else value, threshold)
    return values


def run_scenario(name, spec, root, cam, device='cuda', run=run_subprocess):
    """Run one scenario and check it; returns (passed, message, {gate key:
    (value, threshold)})."""
    module, argv = port_command(spec['command'], root, cam, device)
    print(f'\n=== {name} ===\n$ python3 -m {module} {shlex.join(argv)}', flush=True)
    code, output = run(module, argv)
    if code != 0:
        print('\n'.join(output.splitlines()[-40:]))
        return False, f'command exited with {code}', {}
    missing = missing_artifacts(spec, root, cam)
    if missing:
        return False, f'missing artifact: {missing[0]}', {}
    values = gate_values(spec, root, cam)
    for key, (value, threshold) in values.items():
        if not value >= threshold:
            return False, f'{key} = {value} < {threshold}', values
        print(f'  ✓ {key} = {value:.3f} (>= {threshold})', flush=True)
    return True, 'ok', values


def run_all(scenarios, root, cam, device='cuda', run=run_subprocess):
    """Run the scenarios in order, skipping those whose prerequisite did not
    pass; returns {name: {'status', 'message', 'seconds', 'gates'}}."""
    for spec in scenarios.values():
        port_command(spec['command'], root, cam, device)    # every script has a port CLI
    results = {}
    for name, spec in scenarios.items():
        blocked = [d for d in DEPENDENCIES.get(name, ())
                   if d in results and results[d]['status'] != 'PASS']
        if blocked:
            results[name] = {'status': 'SKIP', 'seconds': 0.0, 'gates': {},
                             'message': f'prerequisite did not pass: {", ".join(blocked)}'}
        else:
            t0 = time.perf_counter()
            ok, message, gates = run_scenario(name, spec, root, cam, device, run)
            results[name] = {'status': 'PASS' if ok else 'FAIL', 'message': message,
                             'seconds': time.perf_counter() - t0, 'gates': gates}
        r = results[name]
        print(f'--- {name}: {r["status"]} ({r["message"]}) in {r["seconds"]:.1f} s', flush=True)
    return results


def summarize(results):
    """Print the summary table; returns the number of scenarios that did not
    pass."""
    print('\n=== Summary ===')
    for name, r in results.items():
        print(f'{r["status"]:4s}  {name:24s} {r["seconds"]:8.1f} s  {r["message"]}', flush=True)
    return sum(r['status'] != 'PASS' for r in results.values())


def build_parser():
    parser = argparse.ArgumentParser(description='End-to-end framework test (PyTorch port)')
    parser.add_argument('--root', default=DEFAULT_ROOT, help='scratch root for data and runs')
    parser.add_argument('--cam', default=DEFAULT_CAM)
    parser.add_argument('--spec', default=SPEC)
    parser.add_argument('--scenario', default=None, help='run only one scenario')
    parser.add_argument('--fresh', action='store_true', help='wipe the scratch root first')
    parser.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()
    resolve_device(args.device)
    scenarios = load_spec(args.spec)
    if args.scenario:
        scenarios = {args.scenario: scenarios[args.scenario]}
    if args.fresh and os.path.isdir(args.root):
        shutil.rmtree(args.root)
    os.makedirs(args.root, exist_ok=True)
    prepare_data(args.root, args.cam)
    failed = summarize(run_all(scenarios, args.root, args.cam, args.device))
    sys.exit(1 if failed else 0)


if __name__ == '__main__':
    main()
