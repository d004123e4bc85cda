"""PyTorch port: model files, charset mapping and batch encoding.

The port (cor_asv_ann_tpu_torch) keeps its own copies of the JAX
package's host modules; these tests hold them against the originals on
the bundled model files, hold the files its numpy-only writer makes
against h5py, its own reader and the JAX package's loaders, and check
that the port imports nothing of JAX or of the JAX package.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from cor_asv_ann_tpu.utils import data as jdata
from cor_asv_ann_tpu.utils import io_h5 as jio
from cor_asv_ann_tpu_torch.utils import data as tdata
from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig, init_params
from cor_asv_ann_tpu_torch.utils import h5read, h5write
from cor_asv_ann_tpu_torch.utils import io_h5 as tio
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, 'testmodels')
FILES = ['flagship.d2.w512.synthetic.h5', 'reference_trained.w64.h5',
         'soak.d2.w128.synthetic.h5']


def _assert_tree_equal(a, b, path=''):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], path + '/' + k)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, '%s[%d]' % (path, i))
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize('name', FILES[:2])
def test_load_matches_jax_package(name):
    path = os.path.join(MODELS, name)
    jconfig, jmap = jio.load_config(path)
    tconfig, tmap = tio.load_config(path)
    assert jconfig.as_dict() == tconfig.as_dict()
    assert jmap.c2i == tmap.c2i
    _assert_tree_equal(jio.load_weights(path, jconfig),
                       tio.load_weights(path, tconfig))


def _attrs_equal(a, b, where):
    assert set(a.attrs.keys()) == set(b.attrs.keys()), where
    for key in a.attrs:
        x, y = a.attrs[key], b.attrs[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (where, key)
            assert (x == y).all(), (where, key)
        else:
            assert x == y, (where, key)


@pytest.mark.parametrize('name', FILES)
def test_h5read_matches_h5py(name, path=None):
    """The numpy-only reader sees every group, attribute and dataset of
    the bundled files exactly as h5py does, in h5py's order."""
    path = path or os.path.join(MODELS, name)
    with h5py.File(path, 'r') as ref, h5read.File(path) as got:
        _attrs_equal(ref, got, '/')
        ref_names, got_names = [], []
        ref.visititems(lambda p, o: ref_names.append(p))
        got.visititems(lambda p, o: got_names.append(p))
        assert ref_names == got_names
        for p in ref_names:
            r, g = ref[p], got[p]
            assert isinstance(g, h5read.Dataset) == isinstance(
                r, h5py.Dataset), p
            _attrs_equal(r, g, p)
            if isinstance(r, h5py.Dataset):
                x, y = np.asarray(r[()]), np.asarray(g[()])
                assert x.dtype == y.dtype and x.shape == y.shape, p
                np.testing.assert_array_equal(x, y, err_msg=p)


def _h5py_view(path):
    """Everything h5py sees in a file: names in its order, object kinds,
    attributes, dataset types, shapes and values."""
    def norm(v):
        return (v.dtype.str, v.shape, v.tolist()) \
            if isinstance(v, np.ndarray) else (type(v).__name__, v)
    view = []
    with h5py.File(path, 'r') as f:
        view.append(('/', {k: norm(v) for k, v in f.attrs.items()}))
        def visit(name, obj):
            entry = [name, type(obj).__name__,
                     {k: norm(v) for k, v in obj.attrs.items()}]
            if isinstance(obj, h5py.Dataset):
                entry.append(norm(np.asarray(obj[()])))
            view.append(entry)
        f.visititems(visit)
    return view


SAVE_CONFIGS = {
    'd2': dict(depth=2),
    'd3_bridge_deep': dict(depth=3, bridge_dense=True, stateful=True,
                           deep_bidirectional_encoder=True,
                           residual_connections=True),
    'd1': dict(depth=1),
}


@pytest.mark.parametrize('name', sorted(SAVE_CONFIGS))
def test_save_model_reads_back_three_ways(name, tmp_path):
    """A file written without h5py looks to h5py exactly like the one the
    JAX package writes with it, and loads equal through h5py, through
    the port's reader and through the JAX package's loaders."""
    mapping = tdata.CharMapping.from_texts(["Wenn die Nacht äöü ſ\n"])
    config = Seq2SeqConfig(width=16, voc_size=mapping.voc_size,
                           **SAVE_CONFIGS[name])
    params = init_params(config, seed=4)
    ours, theirs = str(tmp_path / 'port.h5'), str(tmp_path / 'jax.h5')
    tio.save_model(ours, params, config, mapping)
    jio.save_model(theirs, params, config,
                   jdata.CharMapping.from_codepoints(mapping.to_codepoints()))
    assert _h5py_view(ours) == _h5py_view(theirs)
    for load_config, load_weights in ((tio.load_config, tio.load_weights),
                                      (jio.load_config, jio.load_weights)):
        got_config, got_mapping = load_config(ours)
        assert got_config.as_dict() == dict(config.as_dict(),
                                            dropout=got_config.dropout)
        assert got_mapping.c2i == mapping.c2i
        _assert_tree_equal(load_weights(ours, got_config), params)
    test_h5read_matches_h5py(ours, path=ours)


def test_h5write_types_nesting_and_many_links(tmp_path):
    """What save_model does not reach: more links than one symbol-table
    node holds (9 and more), other integer and float types, empty and
    0-d datasets, str attributes, attributes on datasets."""
    path = str(tmp_path / 'w.h5')
    with h5write.File(path, 'w') as f:
        f.attrs['title'] = 'Straße'
        for i in range(41):
            g = f.create_group('layer_%02d' % i)
            g.attrs['weight_names'] = np.array([b'x/k:0', b'x/longer:0'])
            g.create_dataset('x/k:0', data=np.full((2, 3), i, np.float64))
        ds = f.create_dataset('nested/deeper/ints',
                              data=np.arange(-3, 4, dtype=np.int16))
        ds.attrs['scale'] = np.float32(0.5)
        f.create_dataset('nested/empty', data=np.zeros((0, 4), np.float32))
        f.create_dataset('nested/flag', data=np.array(False))
        f.create_dataset('nested/u8', data=np.array(7, np.uint8))
        with pytest.raises(ValueError):
            f.create_group('nested')
        with pytest.raises(ValueError):
            f.create_dataset('c', data=np.array([1j]))
    test_h5read_matches_h5py(path, path=path)
    with h5py.File(path, 'r') as f:
        assert f.attrs['title'] == 'Straße'
        assert len(f) == 42
        assert f['layer_40/x/k:0'][()].tolist() == [[40.0] * 3] * 2
        assert f['nested/deeper/ints'].attrs['scale'] == np.float32(0.5)
        assert f['nested/empty'].shape == (0, 4)
        assert f['nested/flag'][()] == False  # noqa: E712
    with pytest.raises(ValueError):
        h5write.File(path, 'r')


def test_h5write_writes_nothing_when_the_body_raises(tmp_path):
    path = tmp_path / 'never.h5'
    with pytest.raises(KeyError):
        with h5write.File(str(path), 'w') as f:
            f.create_group('a')
            raise KeyError('b')
    assert not path.exists()


def test_h5read_rejects_other_files(tmp_path):
    path = tmp_path / 'not.h5'
    path.write_bytes(b'not an hdf5 file at all')
    with pytest.raises(ValueError):
        h5read.File(str(path))


def test_charmapping_and_index_batches_match():
    texts = ["Wenn die Nacht am tiefſten iſt\n", "ab\tc äöü ß\n",
             "x\ay\n", ""]
    jm = jdata.CharMapping.from_texts(texts[:2])
    tm = tdata.CharMapping.from_texts(texts[:2])
    assert jm.c2i == tm.c2i and jm.i2c == tm.i2c
    np.testing.assert_array_equal(jm.to_codepoints(), tm.to_codepoints())
    for t in texts:
        np.testing.assert_array_equal(jm.encode(t), tm.encode(t))
    for kw in ({}, {'pad_to': 64}, {'bucketed': False}):
        np.testing.assert_array_equal(
            jdata.lines_to_index_batch(jm, texts, **kw),
            tdata.lines_to_index_batch(tm, texts, **kw))
    confs = [[0.5] * len(texts[0]), None, None, None]
    for a, b in zip(jdata.vectorize_lines(jm, texts, texts, confs=confs),
                    tdata.vectorize_lines(tm, texts, texts, confs=confs)):
        np.testing.assert_array_equal(a, b)
    assert tdata.bucket_length(33) == jdata.bucket_length(33) == 64
    assert tdata.bucket_length(2000) == jdata.bucket_length(2000)


def test_port_imports_without_jax():
    """Every module of the port imports with `jax`, `optax` and `h5py`
    blocked, and no module of the JAX package gets loaded along the way."""
    code = r'''
import sys, pkgutil, importlib
for blocked in ('jax', 'optax', 'h5py'):
    sys.modules[blocked] = None
import cor_asv_ann_tpu_torch
names = ['cor_asv_ann_tpu_torch']
for info in pkgutil.walk_packages(cor_asv_ann_tpu_torch.__path__,
                                  'cor_asv_ann_tpu_torch.'):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == 'cor_asv_ann_tpu' or m.startswith('cor_asv_ann_tpu.'))
assert not bad, bad
assert sys.modules['jax'] is None
print(' '.join(names), len(names))
'''
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 14
    for name in ('models.train', 'scripts.train', 'ops.lstm_scan_kernel',
                 'utils.h5write', 'lib.alignment', 'utils.prefetch',
                 'utils.synthdata'):
        assert 'cor_asv_ann_tpu_torch.' + name in out.stdout.split(), name
