"""Command-line entry points of the port."""

import logging
import os

import click

# one option text for every CLI that runs a model
device_option = click.option(
    '--device', default='cuda',
    help='torch device to run on (cuda, cuda:N or cpu)')

# cProfile of the run; with either, the program's span totals and
# counters are logged beside its wall time (utils/profiling.py)
profile_option = click.option(
    '--profile', is_flag=True,
    help='profile the run with cProfile (stderr report)')
profile_file_option = click.option(
    '--profile-file', default=None,
    type=click.Path(dir_okay=False, writable=True),
    help='dump cProfile stats to this file')

# the counterpart of the JAX package's --jax-trace (utils/profiling.py)
torch_trace_option = click.option(
    '--torch-trace', default=None, type=click.Path(file_okay=False),
    help='write a torch.profiler trace of the host and the CUDA device '
         '(Chrome trace JSON) to this directory')

# the JAX package's --mesh, for the CLIs that serve
mesh_option = click.option(
    '--mesh', 'mesh_devices', default=0, type=int,
    help='serve over N devices (0 = single device, -1 = all): '
         'data-parallel batches + tensor-parallel weights')


def rank_device(device):
    """The device of this process: under ``torchrun`` (LOCAL_RANK set),
    'cuda' means the local rank's card, cuda:LOCAL_RANK."""
    if device == 'cuda' and 'LOCAL_RANK' in os.environ:
        return 'cuda:%d' % int(os.environ['LOCAL_RANK'])
    return device


def start_mesh(s2s, mesh_devices, what):
    """`s2s.use_mesh` for a CLI's --mesh (0: none, -1: the whole world);
    returns the mesh or None."""
    if not mesh_devices:
        return None
    mesh = s2s.use_mesh(n_devices=None if mesh_devices < 0
                        else mesh_devices)
    logging.info('%s over mesh %s (rank %d)', what, mesh.shape, mesh.rank)
    return mesh


def end_mesh(mesh):
    """After a CLI's work: wait for every rank (rank 0 writes the
    outputs), then leave the process group."""
    if mesh is not None:
        import torch.distributed as dist
        mesh.barrier()
        dist.destroy_process_group()
