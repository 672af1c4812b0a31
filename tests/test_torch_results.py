"""The results layer against the JAX package, on the CPU: ``utils/stats.py``,
``utils/results_data.py`` (the port's tables against the reference's pandas
DataFrames: the same columns, rows and values, CSVs byte for byte, printed
tables as pandas prints them), the shared ``Table``, and the CLIs
``summarize_nip``, ``results``, ``test_nip``, ``diff_nip`` and ``--fill`` of
``train_nip`` / ``train_dcn`` against the root scripts run in this process.

The run trees hold runs of both packages: the JAX package's shipped
``data/m_quality_sweep`` runs and ``data/models/nip`` snapshots, and a joint
run and a NIP snapshot trained by the port's CLIs here."""
import json
import math
import os
import re
import runpy
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from neural_imaging_tpu.utils import results_data as jresults
from neural_imaging_tpu.utils import stats as jstats
from neural_imaging_tpu_torch.cli import (diff_nip, results, summarize_nip, test_nip, train_dcn,
                                          train_manipulation, train_nip)
from neural_imaging_tpu_torch.data import fixtures
from neural_imaging_tpu_torch.utils import results_data, stats
from neural_imaging_tpu_torch.utils.table import Table

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC_INET = os.path.join(ROOT, 'data/models/nip/SyntheticCam/INet_gbrg_5x5')


@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
    return fixtures.make_dataset(str(tmp_path_factory.mktemp('data')), n_images=6, height=64,
                                 width=96)


@pytest.fixture(scope='module')
def tree(data_dir, tmp_path_factory):
    """<root>/m: the shipped λ-sweep runs (QualityRef) and a joint run of the
    port's trainer (SyntheticCam); <root>/models/nip: the shipped snapshots
    and a UNet trained by the port's train_nip."""
    root = tmp_path_factory.mktemp('tree')
    shutil.copytree(os.path.join(ROOT, 'data/m_quality_sweep/QualityRef'),
                    root / 'm' / 'QualityRef')
    shutil.copytree(os.path.join(ROOT, 'data/models/nip'), root / 'models' / 'nip',
                    ignore=shutil.ignore_patterns('*.jpg', '*.png'))
    train_manipulation.main([
        '--nip', 'INet', '--cam', 'SyntheticCam', '--data', data_dir, '--split', '4:2:2',
        '--epochs', '2', '--patch', '16', '--batch', '2', '--val-schedule', '1', '--jpeg', '50',
        '--train', 'nip', '--fan', "{'n_convolutions': 2, 'n_filters': 8, 'n_dense': 0}",
        '--dir', str(root / 'm'), '--device', 'cpu'])
    train_nip.main(['--nip', 'UNet', '--params', "{'n_steps': 2}", '--cam', 'SyntheticCam',
                    '--data', data_dir, '--split', '4:2:2', '--epochs', '2', '--patch', '16',
                    '--batch', '2', '--val-schedule', '1', '--out',
                    str(root / 'models' / 'nip'), '--device', 'cpu'])
    return root


def same_value(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def assert_same_table(table, frame):
    """The Table holds the DataFrame's columns, rows and values, and writes its
    CSV and prints its text as pandas does."""
    assert isinstance(table, Table)
    assert table.columns == list(frame.columns)
    rows = frame.to_dict('records')
    assert len(table.rows) == len(rows)
    for got, want in zip(table.rows, rows):
        assert all(same_value(got[c], want[c]) for c in table.columns), (got, want)
    assert table.to_string(index=False) == frame.to_string(index=False)


def assert_same_csv(table, frame, tmp_path):
    table.to_csv(tmp_path / 'port.csv')
    frame.to_csv(tmp_path / 'ref.csv', index=False)
    assert (tmp_path / 'port.csv').read_bytes() == (tmp_path / 'ref.csv').read_bytes()


@pytest.mark.parametrize('n', [1, 2])
def test_nip_stats_is_the_reference_table(tree, n, tmp_path):
    table = results_data.nip_stats(str(tree / 'models' / 'nip'), avg_last_n_runs=n)
    frame = jresults.nip_stats(str(tree / 'models' / 'nip'), avg_last_n_runs=n)
    assert len(table) == 6 and 'UNet_2' in table.unique('pipeline')
    assert_same_table(table, frame)
    assert_same_csv(table, frame, tmp_path)


@pytest.mark.parametrize('nips, cameras', [(None, None), ('INet', None), (['UNet'], ['QualityRef'])])
def test_manipulation_metrics_is_the_reference_table(tree, nips, cameras, tmp_path):
    table = results_data.manipulation_metrics(nips, cameras, root_dir=str(tree / 'm'))
    frame = jresults.manipulation_metrics(nips, cameras, root_dir=str(tree / 'm'))
    assert len(table) > 0
    assert_same_table(table, frame)
    assert_same_csv(table, frame, tmp_path)


def test_manipulation_progress_is_the_reference_table(tree, tmp_path):
    cases = [('SyntheticCam', 'INet', 'ln-0.1000/fixed-codec', 0),
             ('QualityRef', 'UNet', 'ln-0.0050/fixed-codec', None), (None, None, 'fixed-nip/fixed-codec', None),
             ('QualityRef', 'UNet', 'ln-9.9/fixed-codec', 0)]
    table, labels = results_data.manipulation_progress(cases, root_dir=str(tree / 'm'))
    frame, ref_labels = jresults.manipulation_progress(cases, root_dir=str(tree / 'm'))
    assert labels == ref_labels and len(labels) == 3
    assert_same_table(table, frame)
    assert_same_csv(table, frame, tmp_path)
    with pytest.raises(RuntimeError, match='Empty'):
        results_data.manipulation_progress([('X', 'INet', 'a/b', 0)], root_dir=str(tree / 'm'))


def test_manipulation_summary_is_the_reference_table(tree, tmp_path):
    table = results_data.manipulation_summary(str(tree / 'm'))
    frame = jresults.manipulation_summary(str(tree / 'm'))
    assert len(table) == 7
    assert_same_table(table, frame)
    assert_same_csv(table, frame, tmp_path)


@pytest.mark.parametrize('run', [None, 0, 1])
def test_confusion_data_is_the_reference(tree, run):
    got = results_data.confusion_data(run=run, root_dir=str(tree / 'm'))
    want = jresults.confusion_data(run=run, root_dir=str(tree / 'm'))
    assert list(got) == list(want)
    assert len(got) == (0 if run == 1 else 7)
    for key in got:
        np.testing.assert_array_equal(got[key]['data'], want[key]['data'])
        assert got[key]['labels'] == want[key]['labels']
        text = results_data.confusion_to_text(100 * got[key]['data'], got[key]['labels'], key)
        assert text == jresults.confusion_to_text(100 * want[key]['data'], want[key]['labels'],
                                                  key)


def test_autodetect_cameras_as_the_reference(tree):
    start = str(tree / 'm' / 'SyntheticCam' / 'INet')
    assert results_data.autodetect_cameras(start) == jresults.autodetect_cameras(start) == [
        'QualityRef', 'SyntheticCam']
    with pytest.raises(ValueError, match='valid results directory'):
        results_data.autodetect_cameras('/')


@pytest.mark.parametrize('fmt', ['txt', 'csv'])
def test_convert_table_as_the_reference(fmt):
    conf = np.random.default_rng(2).random((2, 3)) * 100
    kwargs = dict(labels_rows=['r1', 'r2'], dim_labels='True\\Predicted', title='t', dec=1)
    assert results_data.convert_table(conf, ['a', 'b', 'c'], fmt=fmt, **kwargs) == \
        jresults.convert_table(conf, ['a', 'b', 'c'], fmt=fmt, **kwargs)


def test_convert_table_as_a_table_and_the_refused_forms():
    conf = np.arange(6.0).reshape(2, 3) * 1.26
    table = results_data.convert_table(conf, ['a', 'b', 'c'], fmt='df', labels_rows=['x', 'y'])
    frame = jresults.convert_table(conf, ['a', 'b', 'c'], fmt='df', labels_rows=['x', 'y'])
    assert table['c\\r'].tolist() == list(frame.index)
    for column in 'abc':
        np.testing.assert_array_equal(table[column], frame[column].to_numpy())
    with pytest.raises(NotImplementedError, match='TeX'):
        results_data.convert_table(conf, ['a', 'b', 'c'], fmt='tex')
    with pytest.raises(NotImplementedError, match='TeX'):
        results_data.confusion_to_text(conf[:, :2], ['a', 'b'], fmt='tex')
    with pytest.raises(ValueError, match='backslash'):
        results_data.convert_table(conf, ['a', 'b', 'c'], dim_labels='plain')
    with pytest.raises(NotImplementedError, match='latex'):
        results_data.render_tex('x')


@pytest.mark.parametrize('ext', ['json', 'npz'])
def test_save_and_load_read_across(ext, tmp_path):
    payload = {'accuracy': 0.75, 'confusion': np.eye(2) * 0.5, 'name': 'run'}
    port, ref = tmp_path / f'p.{ext}', tmp_path / f'r.{ext}'
    results_data.save(dict(payload), filename=str(port))
    jresults.save(dict(payload), filename=str(ref))
    for a, b in ((results_data.load(str(port)), jresults.load(str(ref))),
                 (results_data.load(str(ref)), jresults.load(str(port)))):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    with pytest.raises(ValueError, match='Unsupported'):
        results_data.save({}, filename=str(tmp_path / 'x.txt'))


def test_result_cache_as_the_reference(tmp_path, monkeypatch):
    for module, prefix in ((results_data, tmp_path / 'p'), (jresults, tmp_path / 'r')):
        cache = module.ResultCache(['exp_{name}', '{size}px', 'results.json'], str(prefix),
                                   name='a')
        cache.save({'value': 42}, size=64)
        assert cache.load(size=64)['value'] == 42
        assert len(cache.find()) == 1
        with pytest.raises(FileExistsError):
            cache.save({'value': 1}, size=64)
        cache.save({'value': 2}, size=32)
        with pytest.raises(ValueError, match='must match 1 file'):
            cache.filename()
    port = results_data.ResultCache(['exp_{name}', '{size}px', 'results.json'],
                                    str(tmp_path / 'p'), name='a')
    ref = jresults.ResultCache(['exp_{name}', '{size}px', 'results.json'],
                               str(tmp_path / 'r'), name='a')
    assert [os.path.relpath(f, tmp_path / 'p') for f in port.find()] == \
        [os.path.relpath(f, tmp_path / 'r') for f in ref.find()]
    assert list(port.load_all()) == list(ref.load_all())
    assert str(port).replace(str(tmp_path / 'p'), '') == str(ref).replace(str(tmp_path / 'r'), '')
    monkeypatch.chdir(ROOT)
    args = dict(camera='D90', nip='INet', ln='ln-0.1', lc='fixed', run='000')
    assert results_data.ResultCache.format('manipulation-training', 'x', **args) == \
        jresults.ResultCache.format('manipulation-training', 'x', **args)
    named = results_data.ResultCache('nip-progress', 'data', camera='QualityRef')
    assert named.pattern == jresults.ResultCache('nip-progress', 'data', camera='x').pattern
    assert len(named.find(model='UNet_5', scoped='unet')) == 1


def test_table_operations_give_pandas_values(tree):
    table = results_data.manipulation_summary(str(tree / 'm'))
    frame = jresults.manipulation_summary(str(tree / 'm'))
    assert table.nunique('scenario') == frame['scenario'].nunique()
    assert table.nunique('dcn_ssim') == frame['dcn_ssim'].nunique() == 0
    ordered = table.sort_values('scenario')
    assert ordered['scenario'].tolist() == frame.sort_values('scenario', kind='stable')[
        'scenario'].tolist()
    means = {key: group.mean('accuracy') for key, group in table.groupby('scenario')}
    assert means == frame.groupby('scenario')['accuracy'].mean().to_dict()
    assert table.numeric_columns() == list(frame.select_dtypes('number').columns)
    table['twice'] = [2 * a for a in table['accuracy']]
    frame['twice'] = 2 * frame['accuracy']
    assert_same_table(table, frame)
    with pytest.raises(ValueError, match='values for a table'):
        table['x'] = [1]


STATS_CASES = ['span', 'detection_accuracy', 'detection_accuracy_index', 'true_positive_rate',
               'roc', 'auc', 'inlier_rate', 'corrcoeff', 'kld_discrete', 'ma_gaussian',
               'ma_conv', 'ma_conv_auto', 'ma_exp', 'entropy', 'hist_density']


@pytest.mark.parametrize('case', STATS_CASES)
def test_stats_match_the_reference(case):
    rng = np.random.default_rng(11)
    pos, neg = rng.normal(1.0, 1.0, 300), rng.normal(-0.5, 1.2, 400)
    calls = {
        'span': lambda m: m.span(neg, pos, 50),
        'detection_accuracy': lambda m: m.detection_accuracy(pos, neg),
        'detection_accuracy_index': lambda m: m.detection_accuracy(pos, neg, 64, True),
        'true_positive_rate': lambda m: m.true_positive_rate(pos, neg, 0.05),
        'roc': lambda m: m.roc(pos, neg, 80),
        'auc': lambda m: m.auc(pos, neg),
        'inlier_rate': lambda m: m.inlier_rate(pos, neg, 0.1),
        'corrcoeff': lambda m: m.corrcoeff(pos[:200], neg[:200] + pos[:200]),
        'kld_discrete': lambda m: m.kld_discrete(pos, neg),
        'ma_gaussian': lambda m: m.ma_gaussian(np.arange(50.0), pos[:50], 2.0, 3),
        'ma_conv': lambda m: m.ma_conv(pos[:40], 3),
        'ma_conv_auto': lambda m: (m.ma_conv(pos[:40], 0), m.ma_conv([])),
        'ma_exp': lambda m: m.ma_exp(pos[:40], 0.2),
        'entropy': lambda m: m.entropy(np.round(pos * 10)),
        'hist_density': lambda m: m.hist(pos, np.linspace(-3, 3, 9), density=True),
    }
    got, want = calls[case](stats), calls[case](jstats)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_auc_refuses_a_degenerate_sweep_as_the_reference(monkeypatch):
    monkeypatch.setattr(stats, 'roc', lambda *a, **k: ([0.5, 1.0], [0.0, 1.0]))
    with pytest.raises(ValueError, match='Degenerate'):
        stats.auc(np.ones(3), np.zeros(3))


def run_root(script, argv, capsys, monkeypatch):
    """Run a root script of the repository in this process; its stdout."""
    capsys.readouterr()
    monkeypatch.setenv('NI_TPU_CACHE_DIR', '0')
    monkeypatch.setattr(sys, 'argv', [script, *argv])
    runpy.run_path(os.path.join(ROOT, script), run_name='__main__')
    return capsys.readouterr().out


def run_port(main, argv, capsys):
    capsys.readouterr()
    value = main(argv)
    return value, capsys.readouterr().out


@pytest.mark.parametrize('n', ['1', '3'])
def test_summarize_nip_prints_the_reference_table(tree, n, capsys, monkeypatch):
    argv = ['--dir', str(tree / 'models' / 'nip'), '--n', n]
    ref = run_root('summarize_nip.py', argv, capsys, monkeypatch)
    _, out = run_port(summarize_nip.main, argv, capsys)
    assert out == ref
    _, empty = run_port(summarize_nip.main, ['--dir', str(tree / 'm' / 'QualityRef')], capsys)
    assert empty.startswith('No trained NIP models found')


@pytest.mark.parametrize('mode', ['df', 'confusion'])
def test_results_cli_prints_what_the_reference_prints(tree, mode, capsys, monkeypatch):
    argv = [mode, '--dir', str(tree / 'm')]
    ref = run_root('results.py', argv, capsys, monkeypatch)
    _, out = run_port(results.main, argv, capsys)
    assert out == ref


def test_results_auto_prints_the_reference_table(tree, capsys, monkeypatch, tmp_path):
    argv = ['auto', '--dir', str(tree / 'm')]
    ref = run_root('results.py', [*argv, '--out', str(tmp_path / 'auto.png')], capsys,
                   monkeypatch)
    table, out = run_port(results.main, argv, capsys)
    ref_lines, lines = ref.splitlines(), out.splitlines()
    assert ref_lines[0].startswith('figure -> ') and lines[0].startswith('figure: not drawn')
    assert lines[1:] == ref_lines[1:]
    assert len(table) == 7 and table['reps'].tolist() == [1] * 7


@pytest.mark.parametrize('mode', ['boxplot', 'scatter', 'progress'])
def test_results_figure_modes_print_their_table_and_refuse(tree, mode, capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit, match='matplotlib'):
        results.main([mode, '--dir', str(tree / 'm')])
    out = capsys.readouterr().out
    if mode == 'progress':
        table, labels = jresults.manipulation_progress(
            [('QualityRef', 'UNet', 'ln-0.1000/fixed-codec', 0),
             ('QualityRef', 'UNet', 'fixed-nip/fixed-codec', 0),
             ('SyntheticCam', 'INet', 'ln-0.1000/fixed-codec', 0)], root_dir=str(tree / 'm'))
        assert out == '\n'.join(labels) + '\n' + table.to_string(index=False) + '\n'
    else:
        frame = jresults.manipulation_metrics(None, None, root_dir=str(tree / 'm'))
        assert out == frame.to_string(index=False) + '\n'


def patch_lines(text):
    return [tuple(float(v) for v in re.findall(r'patch \d+: ([\d.]+) dB / SSIM ([\d.]+)', line)[0])
            for line in text.splitlines() if line.startswith('patch ')]


def test_test_nip_prints_the_reference_numbers(data_dir, capsys, monkeypatch, tmp_path):
    argv = ['--nip', 'INet', '--cam', 'SyntheticCam', '--data', data_dir,
            '--model-dir', SYNTHETIC_INET, '--patch', '32', '--images', '3']
    ref = run_root('test_nip.py', [*argv, '--out', str(tmp_path / 'fig.png')], capsys,
                   monkeypatch)
    scores, out = run_port(test_nip.main, [*argv, '--device', 'cpu'], capsys)
    got, want = patch_lines(out), patch_lines(ref)
    assert len(got) == len(want) == 3
    # printed at 2 and 3 decimals: one unit of the last digit either way
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=0, atol=0.011)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=0, atol=0.0011)
    assert [(round(p, 2), round(s, 3)) for p, s in scores] == got
    assert 'figure: not written' in out


def test_test_nip_develops_a_raw_file_as_the_reference(capsys, monkeypatch, tmp_path):
    from neural_imaging_tpu_torch.data.png import read_png
    capture = str(tmp_path / 'capture.dng')
    fixtures.make_dng_capture(capture, image_rgb=fixtures.procedural_image(64, 96, 3))
    argv = ['--nip', 'INet', '--cam', 'SyntheticCam', '--raw', capture]
    run_root('test_nip.py', [*argv, '--out', str(tmp_path / 'ref.png')], capsys, monkeypatch)
    developed, out = run_port(test_nip.main, [*argv, '--out', str(tmp_path / 'port.png'),
                                              '--device', 'cpu'], capsys)
    assert out.strip().endswith(f'developed -> {tmp_path / "port.png"}')
    got, want = read_png(str(tmp_path / 'port.png')), read_png(str(tmp_path / 'ref.png'))
    assert got.shape == want.shape == (64, 96, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_diff_nip_prints_the_reference_figures_numbers(data_dir, capsys, monkeypatch, tmp_path):
    from neural_imaging_tpu.data.dataset import Dataset as JaxDataset
    from neural_imaging_tpu.models import base as jbase, pipelines as jpipelines
    from neural_imaging_tpu.utils import metrics as jmetrics
    unet_dir = os.path.join(ROOT, 'data/models/nip/QualityRef/UNet_5')
    argv = ['--a', SYNTHETIC_INET, '--b', unet_dir, '--cam', 'SyntheticCam', '--data', data_dir,
            '--patch', '32', '--image', '1']
    ref = run_root('diff_nip.py', [*argv, '--out', str(tmp_path / 'diff.png')], capsys,
                   monkeypatch)
    assert ref.startswith('figure -> ')
    scores, out = run_port(diff_nip.main, [*argv, '--device', 'cpu'], capsys)
    data = JaxDataset(data_dir, n_images=0, v_images=-1, val_rgb_patch_size=64, val_n_patches=1)
    vx, vy = data.next_validation_batch(1, 1)
    for label, path in (('A', SYNTHETIC_INET), ('B', unet_dir)):
        out_ref = np.asarray(jbase.restore(path, jpipelines, patch_size=None).process(vx))[0]
        psnr, ssim = jmetrics.psnr(vy[0], out_ref), jmetrics.ssim(vy[0], out_ref)
        assert abs(scores[label][0] - psnr) <= 1e-3 and abs(scores[label][1] - ssim) <= 1e-4
        assert f'{label}: {psnr:.1f} dB / {ssim:.3f}' in out
    _, only_a = run_port(diff_nip.main, [*argv[:2], *argv[4:], '--device', 'cpu'], capsys)
    assert 'A: ' in only_a and 'B: ' not in only_a


@pytest.mark.parametrize('fill', ['-', 'summary.csv'])
def test_train_nip_fill_as_the_reference(tree, fill, capsys, monkeypatch, tmp_path):
    target = fill if fill == '-' else str(tmp_path / fill)
    ref_target = fill if fill == '-' else str(tmp_path / 'ref.csv')
    out_dir = str(tree / 'models' / 'nip')
    ref = run_root('train_nip.py', ['--fill', ref_target, '--out', out_dir], capsys, monkeypatch)
    table, out = run_port(train_nip.main, ['--fill', target, '--out', out_dir], capsys)
    assert len(table) == 6
    if fill == '-':
        assert out == ref
    else:
        assert open(target, 'rb').read() == open(ref_target, 'rb').read()
        assert out == ref.replace(ref_target, target)


@pytest.mark.parametrize('fill', ['-', 'results.csv'])
def test_train_dcn_fill_writes_what_pandas_writes(data_dir, fill, capsys, tmp_path):
    rgb = fixtures.make_dataset(str(tmp_path / 'rgb'), n_images=6, height=64, width=96,
                                rgb_only=True)
    table_csv = str(tmp_path / fill) if fill != '-' else '-'
    scenarios = tmp_path / 'scenarios.csv'
    scenarios.write_text('active,n_features,entropy_weight\n1,4,250\n1,6,\n')
    capsys.readouterr()
    train_dcn.main(['--data', rgb, '--split', '4:2:2', '--patch', '32', '--batch', '2',
                    '--epochs', '1', '--val-schedule', '1', '--param_list', str(scenarios),
                    '--out', str(tmp_path / 'out'), '--fill', table_csv, '--device', 'cpu'])
    out = capsys.readouterr().out
    rows = []
    for n_features, params in ((4, {'n_features': 4, 'entropy_weight': 250}),
                               (6, {'n_features': 6})):
        code = f'TwitterDCN-{n_features}C'
        [progress] = [os.path.join(d, 'progress.json') for d, _, files in
                      os.walk(tmp_path / 'out' / code) if 'progress.json' in files]
        perf = json.load(open(progress))['codec']['performance']
        model_code = os.path.relpath(os.path.dirname(os.path.dirname(progress)),
                                     tmp_path / 'out')
        rows.append({**params, 'model_code': model_code,
                     'ssim': perf['ssim']['validation'][-1],
                     'loss': perf['loss']['validation'][-1],
                     'entropy': perf['entropy']['training'][-1]})
    frame = pd.DataFrame(rows)
    if fill == '-':
        assert out.endswith('\n# Training Results\n' + frame.to_string() + '\n')
    else:
        frame.to_csv(tmp_path / 'ref.csv', index=False)
        assert open(table_csv, 'rb').read() == (tmp_path / 'ref.csv').read_bytes()
        assert f'Saving the results table to {table_csv}' in out
