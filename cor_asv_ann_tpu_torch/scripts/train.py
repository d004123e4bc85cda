"""cor-asv-ann-train CLI on the PyTorch port (reference
scripts/train.py:10-97).

Run as ``python -m cor_asv_ann_tpu_torch.scripts.train -m model.h5
data.tsv``. Trains on one GPU (``--device cpu`` for the CPU), or on
several with ``torchrun --nproc-per-node N -m
cor_asv_ann_tpu_torch.scripts.train --mesh -1 ...`` (one process per
device; rank 0 writes the model and the checkpoints).
"""

import logging
import os

import click

from ..utils.profiling import maybe_profile
from . import (device_option, end_mesh, profile_file_option, profile_option,
               rank_device, start_mesh, torch_trace_option)

CONTEXT_SETTINGS = dict(help_option_names=['-h', '--help'])


@click.command(context_settings=CONTEXT_SETTINGS)
@click.option('-m', '--save-model', default='model.h5', show_default=True,
              help='model file for saving',
              type=click.Path(dir_okay=False, writable=True))
@click.option('--load-model', help='model file for loading '
              '(incremental/pre-training)',
              type=click.Path(dir_okay=False, exists=True))
@click.option('--init-model', help='model file for initialisation '
              '(transfer from LM or shallower model)',
              type=click.Path(dir_okay=False, exists=True))
@click.option('--reset-encoder', is_flag=True,
              help='reset encoder weights after load/init')
@click.option('--resume', is_flag=True,
              help='resume from train_state.pkl next to the model file '
                   '(params, optimizer moments, epoch counter)')
@click.option('-w', '--width', default=128, show_default=True,
              type=click.IntRange(min=1, max=9128),
              help='number of nodes per hidden layer')
@click.option('-d', '--depth', default=2, show_default=True,
              type=click.IntRange(min=1, max=10),
              help='number of stacked hidden layers')
@click.option('--compute', default=None,
              type=click.Choice(['float32', 'bfloat16']),
              help='training compute dtype (bfloat16: mixed precision, '
                   'float32 masters)')
@device_option
@click.option('--mesh', 'mesh_devices', default=0, type=int,
              help='train SPMD over a multi-chip (data, model) mesh: '
                   'number of devices, or -1 for all visible devices')
@click.option('-v', '--valdata', multiple=True,
              type=click.Path(dir_okay=False, exists=True),
              help='file to use for validation (instead of random split)')
@click.argument('data', nargs=-1, type=click.Path(dir_okay=False,
                                                  exists=True))
@profile_option
@profile_file_option
@torch_trace_option
def cli(save_model, load_model, init_model, reset_encoder, resume, width,
        depth, compute, device, mesh_devices, valdata, data, profile,
        profile_file, torch_trace):
    """Train a correction model on GT files.

    Configure a sequence-to-sequence model with the given parameters.

    If given `load_model`, and its configuration matches the current
    parameters, then load its weights. If given `init_model`, then
    transfer its mapping and matching layer weights. (Also, if its
    configuration has 1 less hidden layers, then fixate the loaded
    weights afterwards.) If given `reset_encoder`, re-initialise the
    encoder weights afterwards. Then, regardless, train on the `data`
    files using early stopping.

    \b
    (Supported file formats are:
     - * (tab-separated values), with source-target lines
     - *.pkl (pickle dumps), with source-target lines, where source is either
       - a single string, or
       - a sequence of character-probability tuples, or
       - a sequence of alternative lists of character-probability tuples
         ("confmat").)

    If no `valdata` were given, split off a random fraction of lines for
    validation. Otherwise, use only those files for validation.

    If the training has been successful, save the model under `save_model`.

    With `profile`, `profile_file` or `torch_trace`, the training is
    profiled, and the training step's phases (forward, backward, update)
    are logged as span totals beside its wall time.
    """
    if not data:
        raise ValueError('Training needs at least one data file')
    logging.basicConfig(
        format='%(asctime)s.%(msecs)03d %(levelname)s %(name)s - %(message)s',
        datefmt='%H:%M:%S')
    logging.getLogger(__name__).setLevel(logging.DEBUG)

    from ..models.api import Sequence2Sequence
    s2s = Sequence2Sequence(logger=logging.getLogger(__name__),
                            device=rank_device(device))
    s2s.width = width
    s2s.depth = depth
    if compute:
        s2s.train_compute = compute
    if os.environ.get('CORASVANN_TEST_EPOCHS'):
        s2s.epochs = int(os.environ['CORASVANN_TEST_EPOCHS'])
    s2s.configure()

    if load_model:
        prev_mapping = s2s.mapping
        s2s.load_config(load_model)
        if s2s.width == width and s2s.depth == depth:
            logging.info('loading weights from existing model for '
                         'incremental training')
            s2s.configure()
            s2s.load_weights(load_model)
        else:
            logging.warning('ignoring existing model due to different '
                            'topology (width=%d, depth=%d)',
                            s2s.width, s2s.depth)
            # roll back load_config's side effects: train from scratch
            # at the topology the CLI asked for (leaving the loaded
            # width/depth/mapping in place would silently discard -w/-d
            # and desync the mapping from the configured voc_size)
            s2s.width, s2s.depth = width, depth
            s2s.mapping = prev_mapping
            s2s.status = 0
            s2s.configure()
    if init_model:
        s2s.configure()
        s2s.load_transfer_weights(init_model)

    mesh = start_mesh(s2s, mesh_devices, 'training')
    if reset_encoder:
        # keep only decoder weights (e.g. from an LM) as initialization;
        # under a mesh every rank takes rank 0's seed
        from ..models.config import init_params
        seed = int.from_bytes(os.urandom(2), 'little')
        if mesh is not None:
            import torch
            seed = int(mesh.broadcast(torch.tensor([seed],
                                                   device=mesh.device)))
        fresh = init_params(s2s.config, seed=seed)
        s2s.params['encoder'] = fresh['encoder']
        s2s.params['attention_dense'] = fresh['attention_dense']

    # checkpoints (model.ckpt.weights-*.h5 + train_state.pkl) land next
    # to the model artifact, not in whatever CWD the CLI runs from
    with maybe_profile(profile, profile_file, torch_trace,
                       logger=logging.getLogger(__name__)):
        s2s.train(list(data), list(valdata) or None, resume=resume,
                  checkpoint_dir=os.path.dirname(os.path.abspath(save_model)))
    if s2s.status > 1:
        s2s.save(save_model)
    end_mesh(mesh)


if __name__ == '__main__':
    cli()
