"""cor-asv-ann-eval CLI on the PyTorch port (reference scripts/eval.py:10-60).

Run as ``python -m cor_asv_ann_tpu_torch.scripts.eval -m model.h5
gt.tsv``.
"""

import ast
import logging

import click

from ..utils.profiling import maybe_profile
from . import device_option, torch_trace_option

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
@click.option('-n', '--normalization', default='historic_latin',
              type=click.Choice(['Levenshtein', 'NFC', 'NFKC',
                                 'historic_latin']),
              help='normalize character sequences before comparison')
@click.option('-C', '--charmap', default=None,
              help='mapping for input characters before passing to '
                   'correction (dict in Python syntax)')
@click.option('-l', '--gt-level', default=1, type=click.IntRange(1, 3),
              help='GT transcription level for historic_latin')
@click.option('-c', '--confusion', default=10, type=click.IntRange(min=0),
              help='show this number of most frequent (non-identity) edits')
@click.option('-H', '--histogram', is_flag=True,
              help='aggregate and compare character histograms')
@click.argument('data', nargs=-1, type=click.Path(dir_okay=False,
                                                  exists=True))
@click.option('--profile', is_flag=True,
              help='profile the run with cProfile (stderr report)')
@click.option('--profile-file', default=None,
              type=click.Path(dir_okay=False, writable=True),
              help='dump cProfile stats to this file')
@torch_trace_option
@click.option('--compute', default='float32',
              type=click.Choice(['float32', 'bfloat16']),
              help='inference compute dtype (float32: exact reference '
                   'numerics)')
@device_option
def cli(load_model, fast, rejection, normalization, charmap, gt_level,
        confusion, histogram, data, profile, profile_file, torch_trace,
        compute, device):
    """Evaluate a correction model on GT files.

    Load a sequence-to-sequence model from the given path. Then apply on
    the file paths `data`, comparing predictions (both greedy and beamed)
    with GT target, and measuring error rates.

    \b
    (Supported file formats are:
     - * (tab-separated values), with source-target lines
     - *.pkl (pickle dumps), with source-target lines, where source is either
       - a single string, or
       - a sequence of character-probability tuples, or
       - a sequence of alternative lists of character-probability tuples
         ("confmat").)
    """
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
    with maybe_profile(profile, profile_file, torch_trace,
                       logger=logging.getLogger(__name__)):
        s2s.evaluate(list(data), fast=fast,
                     normalization=None if normalization == 'Levenshtein'
                     else normalization,
                     charmap=charmap, gt_level=gt_level,
                     confusion=confusion, histogram=histogram)


if __name__ == '__main__':
    cli()
