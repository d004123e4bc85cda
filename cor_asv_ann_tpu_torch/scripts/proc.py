"""cor-asv-ann-proc CLI on the PyTorch port (reference scripts/proc.py:10-85).

Run as ``python -m cor_asv_ann_tpu_torch.scripts.proc -m model.h5
file.txt``: beam search with rejection, or greedy decoding with
``-f/--fast``.
"""

import ast
import logging
import os

import click

from ..utils.profiling import maybe_profile
from . import (device_option, end_mesh, mesh_option, profile_file_option,
               profile_option, rank_device, start_mesh, torch_trace_option)

CONTEXT_SETTINGS = dict(help_option_names=['-h', '--help'])


@click.command(context_settings=CONTEXT_SETTINGS)
@click.option('-m', '--load-model', default='model.h5',
              help='model file to load',
              type=click.Path(dir_okay=False, exists=True))
@click.option('-f', '--fast', is_flag=True, help='only decode greedily')
@click.option('-r', '--rejection', default=0.5,
              type=click.FloatRange(0, 1.0),
              help='probability of the input characters in all hypotheses '
                   '(set 0 to use raw predictions)')
@click.option('-C', '--charmap', default=None,
              help='mapping for input characters before passing to '
                   'correction (dict in Python syntax)')
@click.option('-S', '--old-suffix', default='',
              help='suffix to remove from input files for output files')
@click.option('-s', '--new-suffix', default='.cor.txt',
              help='suffix to append to input files for output files')
@click.argument('data', nargs=-1, type=click.Path(dir_okay=False,
                                                  exists=True))
@profile_option
@profile_file_option
@torch_trace_option
@mesh_option
@click.option('--compute', default='float32',
              type=click.Choice(['float32', 'bfloat16']),
              help='inference compute dtype (float32: exact reference '
                   'numerics)')
@click.option('--autotune-fused', is_flag=True,
              help='measure fused vs per-op decode on the GPU at serving '
                   'start and set the fused dispatch bound to the largest '
                   'winning batch size (bfloat16 only; costs a few seconds '
                   'once)')
@device_option
def cli(load_model, fast, rejection, charmap, old_suffix, new_suffix, data,
        profile, profile_file, torch_trace, mesh_devices, compute,
        autotune_fused, device):
    """Apply a correction model on GT or text files.

    Load a sequence-to-sequence model from the given path. Then open the
    `data` files, (ignoring target side strings, if any) and apply the
    model to its (source side) strings in batches, accounting for input
    file names line by line.

    \b
    (Supported file formats are:
     - * (plain-text), with source lines,
     - * (tab-separated values), with source-target lines,
     - *.pkl (pickle dumps), with source-target lines, where source is either
       - a single string, or
       - a sequence of character-probability tuples, or
       - a sequence of alternative lists of character-probability tuples
         ("confmat").)

    For each input file, open a new output file derived from its file name
    by removing `old_suffix` (or the last extension) and appending
    `new_suffix`. Write the resulting lines to that output file.

    With `--mesh`, run one process per device under ``torchrun``; rank 0
    writes the output files.
    """
    logging.basicConfig(
        format='%(asctime)s.%(msecs)03d %(levelname)s %(name)s - %(message)s',
        datefmt='%H:%M:%S', level=logging.INFO)
    from ..models.api import Sequence2Sequence
    s2s = Sequence2Sequence(logger=logging.getLogger(__name__),
                            device=rank_device(device))
    s2s.load_config(load_model)
    s2s.configure()
    s2s.load_weights(load_model)
    s2s.rejection_threshold = rejection
    s2s.compute = compute
    mesh = start_mesh(s2s, mesh_devices, 'serving')
    writer = mesh is None or mesh.rank == 0
    if autotune_fused:
        tuned = s2s.autotune_fused_decode()
        if tuned is None:
            logging.info('fused decode unsupported here; autotune skipped')
    if isinstance(charmap, str) and charmap:
        charmap = ast.literal_eval(charmap)

    outfile = None
    lastname = ''
    done = []
    logging.info('running on %d files', len(data))
    try:
        with maybe_profile(profile, profile_file, torch_trace,
                           logger=logging.getLogger(__name__)):
            for filenames, lines, scores in s2s.predict(
                    list(data), fast=fast, greedy=fast, charmap=charmap):
                for filename, line in zip(filenames, lines):
                    if lastname != filename:
                        if outfile and not outfile.closed:
                            done.append(lastname)
                            outfile.close()
                        if not filename:
                            logging.info('done with %d files', len(done))
                            break
                        lastname = filename
                        # strip the suffix only at the END of the name
                        if old_suffix and filename.endswith(old_suffix):
                            basename = filename[:-len(old_suffix)]
                        else:
                            basename, ext = os.path.splitext(filename)
                        if writer:
                            logging.info('writing to output file %r',
                                         basename + new_suffix)
                            outfile = open(basename + new_suffix, 'w',
                                           encoding='utf-8')
                    if outfile:
                        outfile.write(line)
    finally:
        # keep the corrected lines of the current file even when a
        # mid-run error aborts the loop
        if outfile and not outfile.closed:
            outfile.close()
    end_mesh(mesh)


if __name__ == '__main__':
    cli()
