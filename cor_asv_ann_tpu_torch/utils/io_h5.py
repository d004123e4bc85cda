"""Keras-compatible HDF5 model persistence.

A copy of the JAX package's ``utils/io_h5.py``, kept here so the port
imports nothing of that package; the files are read by the numpy-only
``utils/h5read.py`` and written by ``utils/h5write.py`` instead of h5py.
Reads and writes the reference model format (lib/seq2seq.py:1121-1162):
- Keras-2 ``save_weights`` layout: root attr ``layer_names``, one group per
  layer with attr ``weight_names`` and datasets at those paths,
- a custom ``config`` group holding width/depth/stateful/
  residual_connections/deep_bidirectional_encoder/bridge_dense and the
  character mapping as a uint32 codepoint array.

The reader is tolerant: weights are matched by basename (kernel /
recurrent_kernel / bias / W_a / v_a / b_UW / b_v) and position so it copes
with Keras auto-naming of inner layers. CuDNNLSTM weight blobs (double bias
of shape (8N,)) are converted to standard LSTM form by summing both halves
(Keras gate order is (i, f, c~, o) in both implementations).

Transfer loading from a pure LM (top decoder layer without attention
wrapper) and from a depth-1 shallower model is supported like reference
``load_transfer_weights`` (lib/seq2seq.py:1176-1213).

Parameters are the numpy tree on both sides; ``models/params.py`` turns
it into tensors on a device and back.
"""

import numpy as np

from ..models.config import Seq2SeqConfig, init_params
from .data import CharMapping
from . import h5write
from .h5read import Dataset, File


def _collect_datasets(group):
    """Return [(path, array)] for all datasets under `group`, in
    ``weight_names`` attr order if present, else h5 iteration order."""
    out = []
    names = group.attrs.get('weight_names')
    if names is not None:
        for name in names:
            if isinstance(name, bytes):
                name = name.decode('utf8')
            # weight_names may or may not repeat the group prefix
            path = name
            if path not in group:
                parts = path.split('/')
                for k in range(1, len(parts)):
                    sub = '/'.join(parts[k:])
                    if sub in group:
                        path = sub
                        break
            if path in group:
                out.append((path, np.asarray(group[path])))
        return out
    def visit(path, obj):
        if isinstance(obj, Dataset):
            out.append((path, np.asarray(obj)))
    group.visititems(visit)
    return out


def _basename(path):
    base = path.rsplit('/', 1)[-1]
    return base.split(':')[0]


def _pick_lstm(datasets, units):
    """Extract {kernel, recurrent_kernel, bias} from (path, array) pairs,
    converting a CuDNN double bias if present."""
    w = {}
    for path, arr in datasets:
        base = _basename(path)
        if base in ('kernel', 'recurrent_kernel', 'bias'):
            w[base] = arr
    if 'bias' in w and w['bias'].shape[0] == 8 * units:
        w['bias'] = w['bias'][:4 * units] + w['bias'][4 * units:]
    return {k: v.astype(np.float32) for k, v in w.items()}


def load_config(filename):
    """Load (Seq2SeqConfig, CharMapping) from the ``config`` group."""
    with File(filename, 'r') as f:
        root = f
        if 'config' not in root and 'model_weights' in root:
            root = root['model_weights']
        cfg = root['config']
        def get(key, default):
            return bool(cfg[key][()]) if key in cfg else default
        mapping = CharMapping.from_codepoints(cfg['mapping'][()])
        config = Seq2SeqConfig(
            width=int(cfg['width'][()]),
            depth=int(cfg['depth'][()]),
            voc_size=mapping.voc_size,
            stateful=bool(cfg['stateful'][()]) if 'stateful' in cfg else False,
            residual_connections=get('residual_connections', False),
            deep_bidirectional_encoder=get('deep_bidirectional_encoder', False),
            bridge_dense=get('bridge_dense', False),
        )
    return config, mapping


def load_weights(filename, config: Seq2SeqConfig, logger=None,
                 partial=False):
    """Load a full parameter pytree from a reference-format weights file.

    A layer group missing from the file raises ``ValueError`` listing
    every missing layer (a truncated or topology-mismatched file must
    not silently yield a half-random "working" model); pass
    ``partial=True`` to downgrade that to a warning and keep the
    randomly-initialized weights for the missing layers (transfer-style
    loads should use :func:`load_transfer_weights` instead)."""
    params = init_params(config, seed=0)
    W, d = config.width, config.depth
    deep = config.deep_bidirectional_encoder
    missing = []
    LSTM_KEYS = ('kernel', 'recurrent_kernel', 'bias')
    with File(filename, 'r') as f:
        root = f
        if 'layer_names' not in root.attrs and 'model_weights' in root:
            root = root['model_weights']

        def layer_group(name):
            if name in root:
                return root[name]
            missing.append(name)
            return None

        def require(layer, got, want):
            # a group that exists but yields fewer weights than the
            # topology needs (e.g. weight_names paths that resolve to
            # nothing in _collect_datasets) must be as loud as a
            # missing group — never a silently half-random layer
            absent = [k for k in want if k not in got]
            if absent:
                missing.append('%s (present but without %s)'
                               % (layer, ','.join(absent)))

        g = layer_group('char_input_projection')
        if g is not None:
            ds = _collect_datasets(g)
            require('char_input_projection',
                    {'kernel'} if ds else set(), ('kernel',))
            if ds:
                params['char_embedding']['kernel'] = \
                    ds[0][1].astype(np.float32)
        g = layer_group('attention_dense')
        if g is not None:
            ds = _collect_datasets(g)
            require('attention_dense',
                    {'kernel'} if ds else set(), ('kernel',))
            if ds:
                params['attention_dense']['kernel'] = \
                    ds[0][1].astype(np.float32)
        for n in range(d):
            name = 'encoder_lstm_%d' % (n + 1)
            g = layer_group(name)
            if g is None:
                if logger:
                    logger.warning('missing encoder_lstm_%d', n + 1)
                continue
            ds = _collect_datasets(g)
            if n == 0 or deep:
                fw = [(p, a) for p, a in ds if 'forward' in p]
                bw = [(p, a) for p, a in ds if 'backward' in p]
                if not fw:  # fall back to positional halves
                    fw, bw = ds[:len(ds) // 2], ds[len(ds) // 2:]
                wf, wb = _pick_lstm(fw, W), _pick_lstm(bw, W)
                require(name + '/forward', wf, LSTM_KEYS)
                require(name + '/backward', wb, LSTM_KEYS)
                params['encoder'][n]['fw'].update(wf)
                params['encoder'][n]['bw'].update(wb)
            else:
                w = _pick_lstm(ds, W)
                require(name, w, LSTM_KEYS)
                params['encoder'][n].update(w)
        for n in range(d):
            name = 'decoder_lstm_%d' % (n + 1)
            g = layer_group(name)
            if g is None:
                if logger:
                    logger.warning('missing decoder_lstm_%d', n + 1)
                continue
            ds = _collect_datasets(g)
            if n < d - 1:
                w = _pick_lstm(ds, W)
                require(name, w, LSTM_KEYS)
                params['decoder'][n].update(w)
            else:
                top = params['decoder'][n]
                w = _pick_lstm(ds, W)
                require(name + '/cell', w, LSTM_KEYS)
                top['cell'].update(w)
                found = set()
                for path, arr in ds:
                    base = _basename(path)
                    if base in ('W_a', 'v_a', 'b_UW', 'b_v'):
                        top[base] = arr.astype(np.float32)
                        found.add(base)
                require(name + '/attention', found,
                        ('W_a', 'v_a', 'b_UW', 'b_v'))
        if config.bridge_dense:
            for n in range(d):
                for s in ('h', 'c'):
                    name = 'bridge_%s_%d' % (s, n + 1)
                    g = layer_group(name)
                    if g is None:
                        continue
                    ds = _collect_datasets(g)
                    found = set()
                    for path, arr in ds:
                        base = _basename(path)
                        if base in ('kernel', 'bias'):
                            params['bridge'][n][s][base] = \
                                arr.astype(np.float32)
                            found.add(base)
                    require(name, found, ('kernel', 'bias'))
    if missing:
        if not partial:
            raise ValueError(
                '%s is missing layer groups %s for the configured '
                'topology (width %d depth %d); pass partial=True to '
                'load anyway' % (filename, missing, W, d))
        if logger:
            logger.warning('%s: missing layer groups %s left at random '
                           'initialization', filename, missing)
    return params


def save_model(filename, params, config: Seq2SeqConfig, mapping: CharMapping):
    """Save weights + config in the reference's Keras-2-compatible layout,
    so the original tool can load models trained here. `params` is the
    numpy tree (``models/params.py:params_to_numpy`` makes one of a
    tensor tree); the file is written by ``utils/h5write.py``."""
    d = config.depth
    deep = config.deep_bidirectional_encoder

    layers = []  # (layer_name, [(weight_path, array)])
    layers.append(('char_input_projection',
                   [('char_embedding/kernel:0',
                     params['char_embedding']['kernel'])]))
    for n in range(d):
        name = 'encoder_lstm_%d' % (n + 1)
        lw = params['encoder'][n]
        if n == 0 or deep:
            ws = []
            for direction in ('forward', 'backward'):
                sub = lw['fw' if direction == 'forward' else 'bw']
                for base in ('kernel', 'recurrent_kernel', 'bias'):
                    ws.append(('%s/%s_%s/%s:0' % (name, direction, name, base),
                               sub[base]))
        else:
            ws = [('%s/%s:0' % (name, base), lw[base])
                  for base in ('kernel', 'recurrent_kernel', 'bias')]
        layers.append((name, ws))
    layers.append(('attention_dense',
                   [('dense_1/kernel:0', params['attention_dense']['kernel'])]))
    for n in range(d):
        name = 'decoder_lstm_%d' % (n + 1)
        lw = params['decoder'][n]
        if n < d - 1:
            ws = [('%s/%s:0' % (name, base), lw[base])
                  for base in ('kernel', 'recurrent_kernel', 'bias')]
        else:
            # wrapper weights first, then cell weights (Keras weight order
            # of the attention RNN layer: attention.py:421-424)
            ws = [('%s/%s:0' % (name, base), lw[base])
                  for base in ('W_a', 'v_a', 'b_UW', 'b_v')]
            ws += [('%s/%s:0' % (name, base), lw['cell'][base])
                   for base in ('kernel', 'recurrent_kernel', 'bias')]
        layers.append((name, ws))
    if config.bridge_dense:
        for n in range(d):
            for s in ('h', 'c'):
                name = 'bridge_%s_%d' % (s, n + 1)
                lw = params['bridge'][n][s]
                layers.append((name, [('%s/kernel:0' % name, lw['kernel']),
                                      ('%s/bias:0' % name, lw['bias'])]))

    with h5write.File(filename, 'w') as f:
        f.attrs['layer_names'] = np.array(
            [name.encode('utf8') for name, _ in layers])
        f.attrs['backend'] = b'tensorflow'
        f.attrs['keras_version'] = b'2.3.1'
        for name, ws in layers:
            g = f.create_group(name)
            g.attrs['weight_names'] = np.array(
                [p.encode('utf8') for p, _ in ws])
            for path, arr in ws:
                g.create_dataset(path, data=np.asarray(arr, dtype=np.float32))
        cfg = f.create_group('config')
        cfg.create_dataset('width', data=np.array(config.width))
        cfg.create_dataset('depth', data=np.array(config.depth))
        cfg.create_dataset('stateful', data=np.array(config.stateful))
        cfg.create_dataset('residual_connections',
                           data=np.array(config.residual_connections))
        cfg.create_dataset('deep_bidirectional_encoder',
                           data=np.array(config.deep_bidirectional_encoder))
        cfg.create_dataset('bridge_dense', data=np.array(config.bridge_dense))
        cfg.create_dataset('mapping', data=mapping.to_codepoints())


def load_transfer_weights(filename, params, config: Seq2SeqConfig,
                          logger=None):
    """Transfer weights from another (possibly shallower or LM) model.

    Mirrors reference load_transfer_weights (lib/seq2seq.py:1176-1213):
    - layers are matched by name, mismatching shapes are skipped,
    - a pure LM's top ``decoder_lstm_<depth>`` (a plain LSTM without the
      attention wrapper) is loaded into the attention cell only; note the
      LM top-layer kernel has input dim W and our cell expects W+A, so the
      kernel is placed in the first W input rows,
    - returns (params, mapping_or_None, frozen) where `frozen` lists layer
      names to exclude from training when the donor was exactly one layer
      shallower.
    """
    mapping = None
    frozen = []
    donor_depth = None
    with File(filename, 'r') as f:
        root = f
        if 'layer_names' not in root.attrs and 'model_weights' in root:
            root = root['model_weights']
        if 'config' in root:
            cfg = root['config']
            mapping = CharMapping.from_codepoints(cfg['mapping'][()])
            donor_depth = int(cfg['depth'][()])
        W, d = config.width, config.depth

        def try_load(name, target, keys=('kernel', 'recurrent_kernel', 'bias')):
            if name not in root:
                return False
            ds = _collect_datasets(root[name])
            w = _pick_lstm(ds, W)
            for k in keys:
                if k in w and k in target:
                    if w[k].shape == target[k].shape:
                        target[k] = w[k]
                    elif (k == 'kernel'
                          and w[k].shape[1] == target[k].shape[1]
                          and w[k].shape[0] < target[k].shape[0]):
                        # LM decoder top layer: input W instead of W+A
                        target[k] = target[k].copy()
                        target[k][:w[k].shape[0], :] = w[k]
                    elif logger:
                        logger.warning('skipping %s/%s: shape %s vs %s',
                                       name, k, w[k].shape, target[k].shape)
            return True

        if 'char_input_projection' in root:
            ds = _collect_datasets(root['char_input_projection'])
            if ds and ds[0][1].shape == params['char_embedding']['kernel'].shape:
                params['char_embedding']['kernel'] = ds[0][1].astype(np.float32)
        if 'attention_dense' in root:
            ds = _collect_datasets(root['attention_dense'])
            if ds and ds[0][1].shape == params['attention_dense']['kernel'].shape:
                params['attention_dense']['kernel'] = ds[0][1].astype(np.float32)
        deep = config.deep_bidirectional_encoder
        for n in range(d):
            name = 'encoder_lstm_%d' % (n + 1)
            if name not in root:
                continue
            ds = _collect_datasets(root[name])
            if n == 0 or deep:
                fw = [(p, a) for p, a in ds if 'forward' in p]
                bw = [(p, a) for p, a in ds if 'backward' in p]
                if not fw:  # positional halves, like load_weights
                    fw, bw = ds[:len(ds) // 2], ds[len(ds) // 2:]
                for sub, pair in (('fw', fw), ('bw', bw)):
                    w = _pick_lstm(pair, W)
                    for k, v in w.items():
                        if v.shape == params['encoder'][n][sub][k].shape:
                            params['encoder'][n][sub][k] = v
            else:
                try_load(name, params['encoder'][n])
        for n in range(d):
            name = 'decoder_lstm_%d' % (n + 1)
            if name not in root:
                continue
            if n < d - 1:
                try_load(name, params['decoder'][n])
            else:
                top = params['decoder'][n]
                try_load(name, top['cell'])
                for path, arr in _collect_datasets(root[name]):
                    base = _basename(path)
                    if base in ('W_a', 'v_a', 'b_UW', 'b_v') and \
                            arr.shape == np.asarray(top[base]).shape:
                        top[base] = arr.astype(np.float32)
        if donor_depth is not None and donor_depth == d - 1:
            for i in range(1, d):
                frozen += ['encoder_lstm_%d' % i, 'decoder_lstm_%d' % i]
    return params, mapping, frozen
