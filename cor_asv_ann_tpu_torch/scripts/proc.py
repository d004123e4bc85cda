"""cor-asv-ann-proc CLI on the PyTorch port (reference scripts/proc.py:10-85).

Run as ``python -m cor_asv_ann_tpu_torch.scripts.proc -f -m model.h5
file.txt``. Greedy decoding (``--fast``) only: beam search comes with a
later slice of the port.
"""

import ast
import cProfile
import logging
import os
import pstats
import sys

import click

from . import device_option

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
@click.option('--profile', is_flag=True,
              help='profile the run with cProfile (stderr report)')
@click.option('--profile-file', default=None,
              type=click.Path(dir_okay=False, writable=True),
              help='dump cProfile stats to this file')
@click.option('--compute', default='float32',
              type=click.Choice(['float32', 'bfloat16']),
              help='inference compute dtype (float32: exact reference '
                   'numerics)')
@device_option
def cli(load_model, fast, rejection, charmap, old_suffix, new_suffix, data,
        profile, profile_file, compute, device):
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
    """
    if not fast:
        raise click.UsageError(
            'beam search is not ported yet (ROADMAP.md Queue A item 7); '
            'pass -f/--fast for greedy decoding')
    logging.basicConfig(
        format='%(asctime)s.%(msecs)03d %(levelname)s %(name)s - %(message)s',
        datefmt='%H:%M:%S', level=logging.INFO)
    from ..models.api import Sequence2Sequence
    s2s = Sequence2Sequence(logger=logging.getLogger(__name__),
                            device=device)
    s2s.load_config(load_model)
    s2s.configure()
    s2s.load_weights(load_model)
    s2s.rejection_threshold = rejection
    s2s.compute = compute
    if isinstance(charmap, str) and charmap:
        charmap = ast.literal_eval(charmap)

    prof = cProfile.Profile() if profile or profile_file else None
    outfile = None
    lastname = ''
    done = []
    logging.info('running on %d files', len(data))
    if prof is not None:
        prof.enable()
    try:
        for filenames, lines, scores in s2s.predict(list(data), fast=fast,
                                                    greedy=fast,
                                                    charmap=charmap):
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
                    logging.info('writing to output file %r',
                                 basename + new_suffix)
                    outfile = open(basename + new_suffix, 'w',
                                   encoding='utf-8')
                outfile.write(line)
    finally:
        # keep the corrected lines of the current file even when a
        # mid-run error aborts the loop
        if outfile and not outfile.closed:
            outfile.close()
        if prof is not None:
            prof.disable()
            if profile_file:
                prof.dump_stats(profile_file)
            else:
                pstats.Stats(prof, stream=sys.stderr).sort_stats(
                    'cumulative').print_stats(30)


if __name__ == '__main__':
    cli()
