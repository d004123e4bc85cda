"""cor-asv-ann-transfer-dta-lm on the PyTorch port: convert an ocrd_keraslm
language model into an --init-model for cor-asv-ann-train.

Port of the JAX package's ``scripts/transfer_dta_lm.py`` (the reference's
transfer-dta-lm.py h5 surgery) without h5py: the whole LM file is read
with ``utils/h5read.py``, its ``lstm_<n>`` layer groups are renamed to
``decoder_lstm_<n>`` (the first `depth` of them), the context-input rows
(ocrd_keraslm appends `context_dims` of them to the character input) are
sliced off the first layer's kernel, ``layer_names`` is rewritten, and
the result is written with ``utils/h5write.py``, so that
``load_transfer_weights`` can map the LM onto the decoder stack. h5py sees
the file the JAX script writes: the same names, attributes, dtypes,
shapes and values.

Run as ``python -m cor_asv_ann_tpu_torch.scripts.transfer_dta_lm
lm.h5 init.h5``.
"""

import click
import numpy as np

from ..utils import h5read, h5write

CONTEXT_SETTINGS = dict(help_option_names=['-h', '--help'])


class _Node:
    """One group or dataset of the file in memory: its attributes (a
    variable-length string as ``bytes`` where it was stored as ASCII, as
    ``str`` where as UTF-8, which is how h5py writes either back), and its
    children by name or its data."""

    def __init__(self, attrs, children=None, data=None):
        self.attrs = attrs
        self.children = children
        self.data = data


def _load(obj):
    attrs = {}
    for key, value in obj.attrs.items():
        if isinstance(value, str) and obj.attr_charsets[key] == 'ascii':
            value = value.encode('ascii')
        attrs[key] = value
    if isinstance(obj, h5read.Group):
        return _Node(attrs, {name: _load(obj[name]) for name in obj.keys()})
    return _Node(attrs, data=obj.read())


def _store(node, target):
    target.attrs.update(node.attrs)
    for name in sorted(node.children or ()):
        child = node.children[name]
        _store(child, target.create_group(name) if child.children is not None
               else target.create_dataset(name, data=child.data))


def _find_kernel(node, prefix=''):
    """Path of the first dataset named ``kernel*`` below `node`, depth
    first in h5py's (name) order."""
    for key in sorted(node.children):
        item = node.children[key]
        if item.children is None and key.startswith('kernel'):
            return prefix + key
        if item.children is not None:
            sub = _find_kernel(item, prefix + key + '/')
            if sub:
                return sub
    return None


def transfer(source, target, context_dims=10, depth=None):
    with h5read.File(source) as f:
        root = _load(f)
    names = [n.decode('utf8') if isinstance(n, bytes) else n
             for n in root.attrs.get('layer_names', [])]
    lstm_names = sorted(n for n in names if n.startswith('lstm_'))
    if depth:
        lstm_names = lstm_names[:depth]
    rename = {}
    for n in lstm_names:
        idx = n.split('_')[-1]
        rename[n] = 'decoder_lstm_%s' % idx
    for old, new in rename.items():
        if new in root.children:
            raise ValueError('%s: %r exists already' % (source, new))
        root.children[new] = root.children.pop(old)
    # remove the context-input rows from the first layer's kernel
    first = rename.get('lstm_1')
    if first and first in root.children:
        grp = root.children[first]
        path = _find_kernel(grp)
        if path is not None and context_dims > 0:
            *parents, leaf = path.split('/')
            for part in parents:
                grp = grp.children[part]
            # a new dataset, as h5py's delete and create leave it
            grp.children[leaf] = _Node(
                {}, data=np.asarray(grp.children[leaf].data)[
                    :-context_dims, :])
    new_names = [rename.get(n, n) for n in names]
    root.attrs['layer_names'] = np.array(
        [n.encode('utf8') for n in new_names])
    with h5write.File(target, 'w') as f:
        _store(root, f)
    return target


@click.command(context_settings=CONTEXT_SETTINGS)
@click.option('-c', '--context-dims', default=10, show_default=True,
              help='number of context input dims to slice off the first '
                   'LSTM kernel')
@click.argument('source', type=click.Path(dir_okay=False, exists=True))
@click.argument('target', type=click.Path(dir_okay=False, writable=True))
def cli(context_dims, source, target):
    """Convert an ocrd_keraslm language model HDF5 file into an
    initialization model for cor-asv-ann-train --init-model."""
    transfer(source, target, context_dims=context_dims)
    click.echo('wrote %s' % target)


if __name__ == '__main__':
    cli()
