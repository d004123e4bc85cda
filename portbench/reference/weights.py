"""The weights and charset the benchmark hands to the program and to the
reference: read from a Keras-2 model file, or made from the seed.

Both return the flat float32 parameter dict of ``reference/model.py``.
"""

import hashlib

import numpy as np
import torch

from . import h5read
from .model import param_shapes


def file_sha256(path):
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for block in iter(lambda: f.read(1 << 20), b''):
            h.update(block)
    return h.hexdigest()


def charset_of_file(path):
    """The characters of a model file's ``config/mapping`` (index order;
    index 0 is the empty, underspecified character)."""
    with h5read.File(path, 'r') as f:
        codes = np.asarray(f['config']['mapping'][()]).tolist()
    return ['' if not c else chr(c) for c in codes]


_LSTM = {'kernel': 'K', 'recurrent_kernel': 'R', 'bias': 'b'}


def _flat_name(path):
    """A dataset path of a Keras-2 seq2seq file -> its flat name."""
    parts = path.split('/')
    layer, base = parts[0], parts[-1].split(':')[0]
    if layer == 'char_input_projection':
        return 'E'
    if layer == 'attention_dense':
        return 'A'
    if layer == 'encoder_lstm_1':
        way = 'fw' if any(p.startswith('forward') for p in parts) else 'bw'
        return 'enc1_%s_%s' % (way, _LSTM[base])
    if layer == 'encoder_lstm_2':
        return 'enc2_' + _LSTM[base]
    if layer == 'decoder_lstm_1':
        return 'dec1_' + _LSTM[base]
    if layer == 'decoder_lstm_2':
        return base if base in ('W_a', 'v_a', 'b_UW', 'b_v') \
            else 'top_' + _LSTM[base]
    return None


def load_file(path, device):
    """The flat parameters of a depth-2 model file on `device`."""
    found = {}
    with h5read.File(path, 'r') as f:
        def visit(name, obj):
            if isinstance(obj, h5read.Dataset) and not name.startswith(
                    'config'):
                key = _flat_name(name)
                if key is not None:
                    found[key] = np.asarray(obj, np.float32)
        f.visititems(visit)
    V, W = found['E'].shape
    shapes = param_shapes(V, W)
    for key, shape in shapes.items():
        if key not in found or found[key].shape != shape:
            raise ValueError('%s: %s missing or not of shape %s'
                             % (path, key, shape))
    return {k: torch.from_numpy(found[k]).to(device) for k in shapes}


def init_weights(V, W, seed, device):
    """Weights of a fresh depth-2 model from `seed`, as the train command
    initialises them (Keras defaults): the embedding N(0, 0.001), every
    input kernel and the attention matrices Glorot-uniform, recurrent
    kernels orthogonal a gate at a time, biases 0 but for the forget
    gates' 1. Drawn on `device` by one generator, a call per kind."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    shapes = param_shapes(V, W)
    out = {'E': torch.randn(shapes['E'], generator=g, device=device)
           * 0.001}
    glorot = [k for k in shapes if k.endswith('_K')] + ['A', 'W_a', 'v_a']
    # one uniform draw for every Glorot matrix, scaled per matrix
    sizes = [int(np.prod(shapes[k])) for k in glorot]
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    for k, chunk in zip(glorot, torch.split(flat, sizes)):
        shape = shapes[k]
        limit = float(np.sqrt(6.0 / (shape[0] + shape[-1])))
        out[k] = (chunk * limit).reshape(shape)
    recurrent = [k for k in shapes if k.endswith('_R')]
    a = torch.randn((4 * len(recurrent), W, W), generator=g, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    for n, k in enumerate(recurrent):
        out[k] = torch.cat(list(q[4 * n:4 * n + 4]), dim=1).contiguous()
    for k in shapes:
        if k.endswith('_b'):
            b = torch.zeros(shapes[k], device=device)
            b[W:2 * W] = 1.0
            out[k] = b
    out['b_UW'] = torch.zeros(shapes['b_UW'], device=device)
    out['b_v'] = torch.zeros(shapes['b_v'], device=device)
    return {k: out[k].float().contiguous() for k in shapes}
