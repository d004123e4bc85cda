"""PyTorch port: the fused decode step (K3) reading its window rows by
index (``fused_decode_step_indexed``), and the beam's step through it.

On the CPU the indexed form runs its plain version: the beam's gather of
the window rows (row n on line n // rows_per_line, position j at encoder
row min(win_start[n] + j, T - 1)) followed by the plain K3. It must equal
the gathered form bit for bit, match the JAX package's Pallas kernel in
interpret mode on the gathered rows (float32 2e-5, the bar of the JAX
package's own test of the kernel; bfloat16 weights 2e-2 on the states
and 5e-3 on the two softmaxes, as in test_torch_decode_step_plain.py),
and the beam on its K3 route must hand it the encoder's rows whole and
find the JAX package's hypotheses (indices, lengths, counts equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cor_asv_ann_tpu.models import beam as jbeam
from cor_asv_ann_tpu.models.config import Seq2SeqConfig as JaxConfig
from cor_asv_ann_tpu.models.config import init_params
from cor_asv_ann_tpu.ops import pallas_decode
from cor_asv_ann_tpu_torch.models import beam
from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig
from cor_asv_ann_tpu_torch.models.params import params_from_numpy
from cor_asv_ann_tpu_torch.ops import decode_step_kernel as dsk
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

from conftest import make_onehot_batch

NAMES = ('probs', 'h1', 'c1', 'h2', 'c2', 'align')
V, W, WIN, T = 14, 16, 12, 9
A = JaxConfig(width=W, depth=2, voc_size=V).attended_size


def _inputs(N, rows_per_line, seed):
    """Activations, encoder rows of N // rows_per_line lines (rounded up)
    and window starts over the whole line: windows that run off its end
    (T = 9 < WIN) clamp at T - 1; row 3 has no visible position."""
    rng = np.random.default_rng(seed)
    lines = -(-N // rows_per_line)
    fb = rng.uniform(0, 1, (N, V)).astype(np.float32)
    states = [rng.normal(0, .5, (N, W)).astype(np.float32) for _ in range(4)]
    u = rng.normal(0, .5, (lines, T, W)).astype(np.float32)
    att = rng.normal(0, .5, (lines, T, A)).astype(np.float32)
    start = rng.integers(0, T, N).astype(np.int32)
    start[0] = 0
    visible = rng.random((N, WIN)) < 0.7
    visible[:, 0] = True
    visible[3] = False
    return fb, states, u, att, start, visible


def _gather_np(u, att, rows_per_line, start):
    line = np.arange(len(start))[:, None] // rows_per_line
    ix = np.minimum(start[:, None] + np.arange(WIN), T - 1)
    return u[line, ix], att[line, ix]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('N,rows_per_line', [(8, 1), (37, 5), (70, 5)])
def test_indexed_equals_gathered(N, rows_per_line, dtype):
    """The indexed plain version is the gathered one on the beam's rows,
    bit for bit; the window rows are the numpy gather's."""
    config = JaxConfig(width=W, depth=2, voc_size=V)
    weights = dsk.pack_weights(params_from_numpy(init_params(config, seed=N),
                                                 'cpu'), getattr(torch, dtype))
    fb, states, u, att, start, visible = _inputs(N, rows_per_line, N + 1)
    t = torch.from_numpy
    u_t, att_t = t(u).to(getattr(torch, dtype)), t(att).to(getattr(torch, dtype))
    u_w, att_w = dsk.gather_windows(u_t, att_t, rows_per_line, t(start), WIN)
    want_u, want_att = _gather_np(u, att, rows_per_line, start)
    assert torch.equal(u_w.float(), t(want_u).to(u_t.dtype).float())
    assert torch.equal(att_w.float(), t(want_att).to(u_t.dtype).float())
    acts = [t(fb)] + [t(s) for s in states]
    got = dsk.fused_decode_step_indexed(*acts, u_t, att_t, rows_per_line,
                                        t(start), t(visible), weights)
    want = dsk.fused_decode_step(*acts, u_w, att_w, t(visible), weights)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    assert float(got[5][3].abs().max()) == 0.0        # the masked row
    assert dsk.fused_decode_step_indexed.launches == 0


@pytest.mark.parametrize('N,rows_per_line', [(8, 1), (37, 5)])
@pytest.mark.parametrize('dtype,tol', [
    ('float32', dict(states=2e-5, softmax=2e-5)),
    ('bfloat16', dict(states=2e-2, softmax=5e-3))])
def test_indexed_matches_pallas_interpret(N, rows_per_line, dtype, tol):
    """The indexed form against the Pallas kernel (interpret mode) on the
    window rows gathered in numpy."""
    config = JaxConfig(width=W, depth=2, voc_size=V)
    params = init_params(config, seed=N)
    fb, states, u, att, start, visible = _inputs(N, rows_per_line, N + 2)
    u_w, att_w = _gather_np(u, att, rows_per_line, start)
    want = pallas_decode.fused_decode_step(
        fb, *states, u_w, att_w, visible,
        pallas_decode.pack_weights(params, getattr(jnp, dtype)),
        interpret=True)
    t = torch.from_numpy
    got = dsk.fused_decode_step_indexed(
        t(fb), *(t(s) for s in states), t(u), t(att), rows_per_line,
        t(start), t(visible),
        dsk.pack_weights(params_from_numpy(params, 'cpu'),
                         getattr(torch, dtype)))
    for name, g, w in zip(NAMES, got, want):
        bar = tol['softmax' if name in ('probs', 'align') else 'states']
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=bar,
                                   rtol=0, err_msg=name)


def test_pack_weights_gate_blocks():
    """The kernel's layouts beside the JAX package's entries: [k1; r1] and
    [k2; r2] by slices of 32 units (W = 40: a ragged second slice, zero
    beyond W), E^T and E padded to a multiple of 16 along V, W_a^T."""
    Wd = 40
    config = JaxConfig(width=Wd, depth=2, voc_size=V)
    w = dsk.pack_weights(params_from_numpy(init_params(config, seed=2),
                                           'cpu'), torch.float32)
    Ad = w['k2'].shape[0] - Wd
    US = dsk.UNITS_PER_SLICE
    assert w['z1w'].shape == (4 * 64, 2 * Wd)
    assert w['z2w'].shape == (4 * 64, 2 * Wd + Ad)
    for s in range(2):
        for g in range(4):
            for j in range(US):
                row = s * 4 * US + g * US + j
                u = s * US + j
                if u < Wd:
                    col = g * Wd + u
                    assert torch.equal(w['z1w'][row], torch.cat(
                        [w['k1'][:, col], w['r1'][:, col]]))
                    assert torch.equal(w['z2w'][row], torch.cat(
                        [w['k2'][:, col], w['r2'][:, col]]))
                else:
                    assert float(w['z1w'][row].abs().max()) == 0.0
    assert torch.equal(w['Ep'][:V], w['E']) and w['Ep'].shape == (16, Wd)
    assert float(w['Ep'][V:].abs().max()) == 0.0
    assert torch.equal(w['ET'], w['Ep'].t())
    assert torch.equal(w['W_aT'], w['W_a'].t())


LINES = ["abba dig.\n", "chef i gad.\n", "hi.\n"]
BEAM_T = 12


@pytest.mark.parametrize('seed', [7, 23, 42])
def test_beam_step_kernel_route_reads_rows_by_index(seed, monkeypatch):
    """decode_beam on the K3 route ('on'; the plain version on the CPU):
    every iteration hands `fused_decode_step_indexed` the encoder's rows
    whole (lines x T), the rows of a line being its K hypotheses, and the
    search finds the JAX package's hypotheses (tests/test_torch_beam.py's
    tiny peaked models)."""
    from cor_asv_ann_tpu.utils.data import CharMapping
    mapping = CharMapping.from_texts(["abcdefghij .,\n"])
    jc = JaxConfig(width=8, depth=2, voc_size=mapping.voc_size)
    params = init_params(jc, seed=seed)
    params['char_embedding']['kernel'] *= 400.0
    tc = Seq2SeqConfig(width=8, depth=2, voc_size=mapping.voc_size)
    bounds = dict(reservoir=32, expand=8, beam_width_in=6, beam_width_out=4)
    enc = make_onehot_batch(mapping, LINES, pad_to=BEAM_T)
    src_len = np.full(len(LINES), BEAM_T, np.int32)
    want = jbeam.decode_beam(params, jc, jbeam.BeamParams(**bounds), enc,
                             mapping.get('\n'), src_len)
    calls = []
    indexed = beam.fused_decode_step_indexed

    def recorded(fb, h1, c1, h2, c2, u, attended, rows_per_line, *rest):
        calls.append((fb.shape[0], tuple(u.shape), tuple(attended.shape),
                      rows_per_line))
        return indexed(fb, h1, c1, h2, c2, u, attended, rows_per_line, *rest)

    monkeypatch.setattr(beam, 'fused_decode_step_indexed', recorded)
    monkeypatch.setattr(beam, '_BEAM_STEP_KERNEL', 'on')
    got = beam.decode_beam(params_from_numpy(params, 'cpu'), tc,
                           beam.BeamParams(**bounds), torch.from_numpy(enc),
                           mapping.get('\n'), src_len)
    K = bounds['expand']
    assert calls and all(
        c == (len(LINES) * K, (len(LINES), BEAM_T, 8),
              (len(LINES), BEAM_T, calls[0][2][2]), K) for c in calls)
    for key in ('idx', 'length', 'count'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
