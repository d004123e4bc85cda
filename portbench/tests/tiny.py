"""Runs of the benchmark's cells at a size a test can hold, on the CPU
(or on a card), through `portbench/run.py:run` with the look for a chip
left out."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, run  # noqa: E402

PAGES = 'w512.pages.beam_f32'
TRAIN = 'w128.train.masked_f32'


def tiny_cell(name):
    """The cell's files, cut to a test's size: pages of 3-5 lines of
    20-30 characters; or a width-16 model on batches of 8 short lines."""
    workload, config, traffic, entry = run.load_cell(name)
    if name == PAGES:
        workload = dict(workload, pages=4, min_window_units=3,
                        trace_units=1,
                        check=dict(workload['check'], sample_pages=1))
        traffic = dict(traffic, lines_per_page=[3, 5],
                       column_chars=[20, 30])
    else:
        config = dict(config, width=16)
        workload = dict(workload, batches=6, trace_units=1)
        traffic = dict(traffic, batch_size=8, line_chars=[20, 30])
    return workload, config, traffic, entry


def tiny_run(name, seed=2147483911, seconds=0.5, trace=False,
             device='cpu'):
    """(result, checks) of one tiny run of cell `name`."""
    import torch
    workload, config, traffic, entry = tiny_cell(name)
    return run.run(workload, config, traffic, entry, seed, seconds, trace,
                   torch.device(device), harness.load_benchmark(), 1)


def tiny_cell_object(name, seed=2147483911, device='cpu'):
    """A set-up cell of `name` at a test's size, for control readings."""
    import torch
    workload, config, traffic, entry = tiny_cell(name)
    cell = entry.Cell(config, workload, traffic, seed, torch.device(device))
    cell.setup()
    return cell
