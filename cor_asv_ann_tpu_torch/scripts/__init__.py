"""Command-line entry points of the port."""

import click

# one option text for every CLI that runs a model
device_option = click.option(
    '--device', default='cuda',
    help='torch device to run on (cuda, cuda:N or cpu)')

# the counterpart of the JAX package's --jax-trace (utils/profiling.py)
torch_trace_option = click.option(
    '--torch-trace', default=None, type=click.Path(file_okay=False),
    help='write a torch.profiler trace of the host and the CUDA device '
         '(Chrome trace JSON) to this directory')
