"""BENCHMARK.json and the files the harness finds by name."""

import json
import os
import re

import pytest

from tiny import ROOT

from portbench import harness

BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json'),
                       encoding='utf-8'))
LINE = re.compile(r'^[^\n\t]{1,200}$')


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['portbench']
    assert 1 <= len(BENCH['command']) <= 32
    for word in BENCH['command']:
        assert LINE.match(word) and not word.startswith('/') \
            and '..' not in word
    assert isinstance(BENCH['run_seconds'], int)
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_time_of_a_full_check_fits():
    cells = 24
    total = ((2 + 14 * cells) * (BENCH['run_seconds'] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


@pytest.mark.parametrize('entry', BENCH['configs'],
                         ids=[c['name'] for c in BENCH['configs']])
def test_configs(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    harness.check_name(entry['name'], 'config')
    assert LINE.match(entry['source']) and LINE.match(entry['why'])
    assert entry['file'] == 'portbench/configs/%s.json' % entry['name']
    cfg = harness.load_json('configs', entry['name'])
    assert cfg['reduced'] == entry['reduced'] == []
    assert cfg['source'] == entry['source']
    assert any(w['config'] == entry['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('cell', BENCH['workloads'],
                         ids=[w['name'] for w in BENCH['workloads']])
def test_cells_found_by_name(cell):
    assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
    harness.check_name(cell['name'], 'workload')
    harness.check_name(cell['traffic'], 'traffic')
    assert cell['chips'] in (1, 4) and LINE.match(cell['why'])
    workload = harness.load_json('workloads', cell['name'])
    assert workload['name'] == cell['name']
    assert workload['config'] == cell['config']
    assert workload['traffic'] == cell['traffic']
    assert workload['why'] == cell['why']
    harness.load_json('traffic', cell['traffic'])
    assert os.path.exists(os.path.join(harness.BENCH_DIR, 'entries',
                                       workload['entry'] + '.py'))
    e2e, per_layer = harness.metric_specs(BENCH, cell['name'])
    names = [m['name'] for m in e2e]
    assert 'setup_s' in names and len(names) >= 2 and per_layer
    for m in e2e + per_layer:
        if m['name'] != 'setup_s':
            assert os.path.exists(harness.reader_path(m['name']))


def test_metrics():
    e2e, layers = BENCH['end_to_end'], BENCH['per_layer']
    names = [m['name'] for m in e2e + layers]
    assert len(names) == len(set(names))
    cells = {w['name'] for w in BENCH['workloads']}
    for m in e2e:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        bound = m['bound']
        assert 0.01 <= bound <= 0.25
    assert [m for m in e2e if m['name'] == 'setup_s']
    e2e_names = {m['name'] for m in e2e}
    layer_names = {}
    for m in layers:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e_names
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert LINE.match(m['layer'])
        layer_names.setdefault(m['layer'].lower(), set()).add(m['layer'])
        moved = [x for x in e2e if x['name'] == m['moves']][0]
        for w in m['workloads']:
            assert w in cells and w in moved.get('workloads', cells)
    assert all(len(v) == 1 for v in layer_names.values())
    for m in e2e + layers:
        harness.check_name(m['name'], 'metric')
        harness.check_unit(m['unit'])
        assert m['better'] in ('lower', 'higher')
        for w in m.get('workloads', []):
            assert w in cells


@pytest.mark.parametrize('name,ok', [
    ('w512.pages.beam_f32', True), ('_x-1.y', True), ('a' * 64, True),
    ('a' * 65, False), ('a b', False), ('a,b', False), ('a/b', False),
    ('-a', False), ('.a', False), ('µs', False), ('', False)])
def test_name_rule(name, ok):
    if ok:
        harness.check_name(name, 'test')
    else:
        with pytest.raises(ValueError):
            harness.check_name(name, 'test')


@pytest.mark.parametrize('unit,ok', [
    ('lines/s', True), ('%', True), ('launches/step', True), ('ms', True),
    ('tokens per s', False), ('µs', False), ('', False), ('a' * 17, False)])
def test_unit_rule(unit, ok):
    if ok:
        harness.check_unit(unit)
    else:
        with pytest.raises(ValueError):
            harness.check_unit(unit)
