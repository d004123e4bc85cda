"""The benchmark runs the port alone: no JAX, no JAX package, nothing of
the JAX side's measurement files; no result without a card or without
the program."""

import os
import shutil
import subprocess
import sys

from tiny import PAGES, ROOT

BENCH_DIR = os.path.join(ROOT, 'portbench')
THIS = os.path.abspath(__file__)

# blocks the forbidden top-level names in a child process, then runs a
# tiny run of each cell and imports every module of portbench
CHILD = r'''
import importlib, importlib.abc, os, pkgutil, sys
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'cor_asv_ann_tpu'}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in FORBIDDEN:
            raise ImportError('blocked: %s' % name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, TESTS)
import tiny
import portbench
from portbench import harness
for mod in pkgutil.walk_packages(portbench.__path__, 'portbench.'):
    if '.tests' not in mod.name:
        importlib.import_module(mod.name)
# the metric readers are files, not a package: load each one
bench = harness.load_benchmark()
for m in bench['end_to_end'] + bench['per_layer']:
    if m['name'] != 'setup_s':
        harness.load_reader(m['name'])
for name in (tiny.PAGES, tiny.TRAIN):
    result, checks = tiny.tiny_run(name, seconds=0.2)
    assert result['correct'], (name, checks)
loaded = sorted({m.split('.')[0] for m in sys.modules} & FORBIDDEN)
print('LOADED', loaded)
'''


def test_nothing_loads_jax_or_the_jax_package():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    out = subprocess.run(
        [sys.executable, '-c',
         CHILD.replace('TESTS', repr(os.path.dirname(THIS)))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'LOADED []' in out.stdout


# a run whose reader loads a forbidden name after the window: no result
LATE = r'''
import sys, types
sys.path.insert(0, TESTS)
import tiny
from portbench import harness, run

def late_reader(name):
    def read(ctx):
        sys.modules['jax'] = types.ModuleType('jax')
        return 1.0
    return read

harness.load_reader = late_reader
result, checks = tiny.tiny_run(tiny.TRAIN, seconds=0.2)
sys.exit(run.finish(result, checks))
'''


def test_a_late_load_of_jax_gives_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    env.pop('PYTHONPATH', None)
    out = subprocess.run(
        [sys.executable, '-c',
         LATE.replace('TESTS', repr(os.path.dirname(THIS)))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 3, out.stderr[-3000:]
    assert not out.stdout.strip()
    assert 'loaded in this process: jax' in out.stderr


def test_sources_read_nothing_of_the_jax_side():
    bad = ('bench.py', 'tools/', 'BENCH_r', 'BASELINE', 'MULTICHIP_',
           'import jax', 'from jax',
           'cor_asv_ann_tpu.', 'cor_asv_ann_tpu import')
    for root, _, files in os.walk(BENCH_DIR):
        for f in files:
            path = os.path.join(root, f)
            if not f.endswith(('.py', '.json')) or path == THIS:
                continue
            text = open(path, encoding='utf-8').read()
            for word in bad:
                assert word not in text, (path, word)


def run_cli(cwd, env):
    return subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', PAGES,
         '--seed', '2147483923', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = run_cli(ROOT, env)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = run_cli(str(tmp_path), env)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_unknown_cell_no_result():
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'no.such.cell',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
