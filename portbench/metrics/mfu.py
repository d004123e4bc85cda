"""mfu.<cell kind>, in %: the model's FLOPs of the window's work over the
window's seconds times the peak of the cell's compute dtype, from the
untraced units of the window (host clock).

The FLOPs are counted from the configuration's widths and each line's
real length, whatever route or kernel computes them (multiply-adds count
2; element-wise work is left out):

- encoder, per source position: the input projection 2VW, the
  bidirectional first layer 2 x 16W^2, the second layer 2(2W)(4W) + 8W^2,
  the attention projection 2AW;
- decoder, per step and row: the input projection 2VW, the lower layer
  16W^2, the attention query 2W^2, energies and context over the visible
  window 2(2w+1)(W + A), the attention cell 8W(W + A) + 8W^2, the readout
  2WV;
- a page's line: the encoder over its positions, the decoder over its
  served length (with the newline) for as many rows as the reference's
  search expands a line an iteration at the cell's beam parameters
  (``search.expand`` of the cell, ``reference/beam_search.py``);
- a training line: the encoder over the source, the decoder over the
  target (with the newline), and the backward pass twice the forward.

Peaks: NVIDIA H100 SXM, dense, without sparsity: 67 TFLOP/s float32
(outside the tensor cores), 989 TFLOP/s bfloat16.
"""

PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}


def encoder_flops(cfg, n):
    W, V = cfg['width'], cfg['voc_size']
    A = W
    return n * (2 * V * W + 2 * 16 * W * W + 2 * (2 * W) * (4 * W)
                + 8 * W * W + 2 * A * W)


def decoder_flops(cfg, n):
    W, V = cfg['width'], cfg['voc_size']
    A = W
    span = 2 * cfg['window_width'] + 1
    return n * (2 * V * W + 16 * W * W + 2 * W * W + 2 * span * (W + A)
                + 8 * W * (W + A) + 8 * W * W + 2 * W * V)


def unit_flops(cfg, workload, u):
    if 'out_lens' in u:
        rows = workload['search']['expand']
        return sum(encoder_flops(cfg, s) + rows * decoder_flops(cfg, o)
                   for s, o in zip(u['src_lens'], u['out_lens']))
    return 3 * sum(encoder_flops(cfg, s) + decoder_flops(cfg, t)
                   for s, t in zip(u['src_lens'], u['tgt_lens']))


def read(ctx):
    units = ctx.units(traced=False)
    if not units:
        return None
    seconds = units[-1]['t1'] - units[0]['t0']
    flops = sum(unit_flops(ctx.config, ctx.workload, u) for u in units)
    return 100.0 * flops / (seconds * PEAK_FLOPS[ctx.workload["compute"]])
