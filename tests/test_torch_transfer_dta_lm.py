"""PyTorch port: scripts/transfer_dta_lm.py against the JAX package's.

The same seeded ocrd_keraslm-shaped language model file (the layout of
Keras 2's ``save_weights``: ``layer_names``, ``backend`` and
``keras_version`` on the root, ``weight_names`` and nested
``<layer>/<layer>/<weight>:0`` datasets on each layer group; the first
LSTM's input is V + 10 wide) goes through the JAX script, which edits a
copy with h5py, and through the port's, which reads it with
``utils/h5read.py`` and writes it with ``utils/h5write.py``. h5py must see
the same file in both: every name in its order, every attribute with its
dtype (string character sets included) and value, every dataset's dtype,
shape and values, exactly. Both packages' ``load_transfer_weights`` then
give equal parameters. The LM is written once with h5py and once with
the port's writer, as the card's smoke test writes it.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
from click.testing import CliRunner

from cor_asv_ann_tpu.models.api import Sequence2Sequence as JaxS2S
from cor_asv_ann_tpu.models.config import init_params
from cor_asv_ann_tpu.scripts import transfer_dta_lm as jtransfer
from cor_asv_ann_tpu.utils.data import CharMapping as JaxCharMapping
from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
from cor_asv_ann_tpu_torch.scripts import transfer_dta_lm as ttransfer
from cor_asv_ann_tpu_torch.utils import h5write
from cor_asv_ann_tpu_torch.utils.data import CharMapping
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARS = "abcdefghij .,\n"
W = 8


def write_lm(f, voc_size, width, depth, seed, context_dims=10):
    """Fill an open h5py-like file `f` with a Keras-2-style LM of `depth`
    LSTM layers of `width` units over a one-hot input of voc_size +
    context_dims, then a dense readout; random weights from `seed`."""
    rng = np.random.default_rng(seed)
    lstms = ['lstm_%d' % (i + 1) for i in range(depth)]
    layers = ['input_1'] + lstms + ['dense_1']
    f.attrs['layer_names'] = np.array([n.encode('utf8') for n in layers])
    f.attrs['backend'] = b'tensorflow'
    f.attrs['keras_version'] = b'2.2.4'
    f.attrs['model_name'] = 'dta-lm ſ'           # a UTF-8 string
    f.attrs['stateful'] = np.array(True)
    f.create_group('input_1').attrs['weight_names'] = np.array([])
    shapes = {}
    for i, name in enumerate(lstms):
        rows = voc_size + context_dims if i == 0 else width
        shapes[name] = [('kernel:0', (rows, 4 * width)),
                        ('recurrent_kernel:0', (width, 4 * width)),
                        ('bias:0', (4 * width,))]
    shapes['dense_1'] = [('kernel:0', (width, voc_size)),
                         ('bias:0', (voc_size,))]
    for name, weights in shapes.items():
        group = f.create_group(name)
        group.attrs['weight_names'] = np.array(
            [('%s/%s' % (name, w)).encode('utf8') for w, _ in weights])
        for w, shape in weights:
            group.create_dataset('%s/%s' % (name, w), data=(
                rng.standard_normal(shape) * 0.3).astype(np.float32))


def _attr_view(obj):
    out = {}
    for key in obj.attrs:
        value = obj.attrs[key]
        dtype = obj.attrs.get_id(key).dtype
        out[key] = (str(dtype), h5py.check_string_dtype(dtype),
                    (value.dtype.str, value.shape, value.tolist())
                    if isinstance(value, np.ndarray)
                    else (type(value).__name__, value))
    return out


def h5py_view(path):
    """Everything h5py tells of a file: names in its order, object kinds,
    attributes with their dtypes, dataset dtypes, shapes and values."""
    with h5py.File(path, 'r') as f:
        view = [('/', _attr_view(f))]

        def visit(name, obj):
            entry = [name, type(obj).__name__, _attr_view(obj)]
            if isinstance(obj, h5py.Dataset):
                data = obj[()]
                entry.append((str(obj.dtype), obj.shape,
                              np.asarray(data).tolist()))
            view.append(entry)
        f.visititems(visit)
    return view


@pytest.fixture(params=['h5py', 'h5write'])
def lm_file(request, tmp_path):
    path = str(tmp_path / 'lm.h5')
    opener = h5py.File if request.param == 'h5py' else h5write.File
    with opener(path, 'w') as f:
        write_lm(f, len(CHARS) + 1, W, 3, seed=5)
    return path


@pytest.mark.parametrize('context_dims', [10, 0])
@pytest.mark.parametrize('depth', [1, 2, None])
def test_transfer_matches_the_jax_script(lm_file, tmp_path, context_dims,
                                         depth):
    ours, theirs = str(tmp_path / 'port.h5'), str(tmp_path / 'jax.h5')
    assert ttransfer.transfer(lm_file, ours, context_dims, depth) == ours
    jtransfer.transfer(lm_file, theirs, context_dims, depth)
    view = h5py_view(ours)
    assert view == h5py_view(theirs)
    names = [entry[0] for entry in view]
    kept = 3 if depth is None else depth
    assert ['decoder_lstm_%d' % (i + 1) in names for i in range(3)] \
        == [i < kept for i in range(3)]
    with h5py.File(ours, 'r') as f:
        kernel = f['decoder_lstm_1/lstm_1/kernel:0']
        assert kernel.shape == (len(CHARS) + 1 + 10 - context_dims, 4 * W)


def _model(cls, mapping):
    s2s = cls(**({'device': 'cpu'} if cls is Sequence2Sequence else {}))
    s2s.mapping = mapping.from_texts([CHARS])
    s2s.width, s2s.depth = W, 2
    s2s.configure()
    s2s.params = init_params(s2s.config, seed=3)
    return s2s


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
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_both_packages_load_the_transfer_alike(lm_file, tmp_path):
    """The port's file into the port's model and the JAX script's into
    the JAX package's: equal parameters, the LM's layers in the decoder
    (the top one into the first W input rows of the attention cell)."""
    ours, theirs = str(tmp_path / 'port.h5'), str(tmp_path / 'jax.h5')
    ttransfer.transfer(lm_file, ours, 10, 2)
    jtransfer.transfer(lm_file, theirs, 10, 2)
    port, jax = (_model(Sequence2Sequence, CharMapping),
                 _model(JaxS2S, JaxCharMapping))
    before = init_params(port.config, seed=3)
    port.load_transfer_weights(ours)
    jax.load_transfer_weights(theirs)
    _assert_tree_equal(port.params, jax.params)
    assert port.frozen_layers == jax.frozen_layers
    with h5py.File(ours, 'r') as f:
        r2 = np.asarray(f['decoder_lstm_2/lstm_2/recurrent_kernel:0'])
        k2 = np.asarray(f['decoder_lstm_2/lstm_2/kernel:0'])
    top = port.params['decoder'][1]['cell']
    np.testing.assert_array_equal(top['recurrent_kernel'], r2)
    np.testing.assert_array_equal(top['kernel'][:W], k2)
    assert not np.array_equal(top['kernel'][:W],
                              before['decoder'][1]['cell']['kernel'][:W])


def test_cli(lm_file, tmp_path):
    """Through click's runner, and as a module with h5py blocked."""
    target = str(tmp_path / 'init.h5')
    res = CliRunner().invoke(ttransfer.cli, ['-c', '10', lm_file, target])
    assert res.exit_code == 0, res.output
    assert res.output == 'wrote %s\n' % target
    again = str(tmp_path / 'again.h5')
    code = ("import sys, runpy; sys.modules['h5py'] = None; "
            "sys.argv[0] = 'transfer_dta_lm'; runpy.run_module("
            "'cor_asv_ann_tpu_torch.scripts.transfer_dta_lm', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, '-c', code, lm_file, again],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert h5py_view(again) == h5py_view(target)
