"""PyTorch port: bfloat16 window positions past T = 256, against the JAX
package.

bfloat16 holds every integer up to 256 exactly and only every second one
up to 512. The JAX package's dense bfloat16 attention step
(``ops/attention.py:_attention_step``) compares window positions on that
grid, and its beam step (``models/beam.py:beam_decoder_step``) computes
the expected position and the window in bfloat16 too; the port's
whole-loop kernel K1 (``decode_loop_reference``'s `window_keep`) keeps
positions exact in float32. So past 256 the two see other windows:

- the dense step and K1's window test part where t0 > 256 and agree up
  to 256, which is why serving sends K1 buckets up to 256 only
  (`loop_covers`), and longer ones to the windowed decoder, as the JAX
  package does;
- the port's beam step computes positions in bfloat16 past 256
  (`_position_dtype`) and then finds the JAX step's windows, starts and
  expected positions exactly, where float32 positions would not; K3 takes
  bfloat16 buckets up to 256 only.

The dispatch is checked on the CPU with the card's support predicates
patched to hold (their card halves are in tests/test_torch_cuda.py), and
long lines go through ``correct_lines`` of both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cor_asv_ann_tpu.models import beam as jbeam
from cor_asv_ann_tpu.models.api import Sequence2Sequence as JaxS2S
from cor_asv_ann_tpu.models.config import Seq2SeqConfig as JaxConfig
from cor_asv_ann_tpu.models.config import init_params
from cor_asv_ann_tpu.ops import attention as jattention
from cor_asv_ann_tpu.utils.data import CharMapping as JaxCharMapping
from cor_asv_ann_tpu_torch.models import api, beam
from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig
from cor_asv_ann_tpu_torch.models.params import params_from_numpy
from cor_asv_ann_tpu_torch.ops import attention
from cor_asv_ann_tpu_torch.ops import decode_loop_kernel as dlk
from cor_asv_ann_tpu_torch.utils.data import CharMapping
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

W = 8
WW = 5
CHARS = "abcdefghij .,\n"
V = len(CHARS) + 1
BF = torch.bfloat16


def _params(seed=3):
    return init_params(JaxConfig(width=W, depth=2, voc_size=V), seed=seed)


def _bf16_pair(x):
    """A float32 numpy array as bfloat16 in both libraries."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(BF)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _peaked_alignment(T, centres, rng):
    """(B, T) alignments, each split between two neighbours of a centre
    (a fraction of a position past it)."""
    a = np.zeros((len(centres), T), np.float32)
    for row, p in enumerate(centres):
        w = rng.uniform(0.05, 0.95)
        a[row, p], a[row, p + 1] = 1.0 - w, w
    return a


def _dense_step_visible(T, centres, seed):
    """The positions the JAX dense bf16 step keeps visible, the port's
    dense bf16 step, and K1's window test, for alignments around
    `centres`."""
    rng = np.random.default_rng(seed)
    top = _params()['decoder'][1]
    B = len(centres)
    args = [top['W_a'], top['v_a'], top['b_UW'], top['b_v'],
            rng.standard_normal((B, W)) * 0.5,
            _peaked_alignment(T, centres, rng),
            rng.standard_normal((B, T, W)) * 0.5,
            rng.standard_normal((B, T, W)) * 0.5]
    pairs = [_bf16_pair(x) for x in args]
    _, a_jax = jattention._attention_step(*(j for j, _ in pairs), WW)
    _, a_port = attention._attention_step(*(t for _, t in pairs), WW)
    prev_a = pairs[5][1]
    everywhere = torch.ones((B, T), dtype=torch.bool)
    steps_f = torch.arange(T, dtype=torch.float32)[None, :]
    keep_k1 = dlk.window_keep(prev_a, steps_f, WW, everywhere)
    # the rule the JAX step follows: positions on the bfloat16 grid
    steps_bf = torch.arange(T).to(BF).float()[None, :]
    on_grid = dlk.window_keep(prev_a, steps_bf, WW, everywhere)
    return (np.asarray(a_jax.astype(jnp.float32)) > 0,
            a_port.float().numpy() > 0, keep_k1.numpy(), on_grid.numpy())


def test_dense_step_and_k1_part_past_256():
    """t0 in (256, 512): the JAX step keeps the positions whose bfloat16
    rounding lies within the window of the t0 computed from them (the
    port's dense step alike), K1 the 10 exact ones; they differ on most
    of these lines."""
    centres = [257, 280, 301, 333, 390, 444, 470, 499]
    jax_vis, port_vis, k1_vis, on_grid = _dense_step_visible(
        512, centres, seed=1)
    np.testing.assert_array_equal(jax_vis, on_grid)
    np.testing.assert_array_equal(port_vis, on_grid)
    assert all(k1_vis.sum(axis=1) == 2 * WW)
    differ = [c for row, c in enumerate(centres)
              if not np.array_equal(jax_vis[row], k1_vis[row])]
    assert len(differ) >= 6, differ


def test_dense_step_and_k1_agree_up_to_256():
    centres = [1, 17, 64, 100, 128, 129, 200, 243]
    jax_vis, port_vis, k1_vis, on_grid = _dense_step_visible(
        256, centres, seed=2)
    np.testing.assert_array_equal(on_grid, k1_vis)
    np.testing.assert_array_equal(jax_vis, k1_vis)
    np.testing.assert_array_equal(port_vis, k1_vis)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_beam_step_positions_past_256(seed):
    """The beam's per-op step at T = 384 in bfloat16 against the JAX
    step: equal window starts and visible positions, equal expected
    positions (both bfloat16, exactly); float32 positions would start
    other windows."""
    T, B, K = 384, 4, 3
    WIN = 2 * WW + 2
    rng = np.random.default_rng(seed)
    params = _params()
    astart = rng.integers(250, T - WIN, size=(B, K)).astype(np.int32)
    aw = rng.random((B, K, WIN)).astype(np.float32) ** 4
    aw /= aw.sum(axis=-1, keepdims=True)
    arrays = [rng.random((B, K, V)), aw,
              rng.standard_normal((B, T, W)) * 0.5,
              rng.standard_normal((B, T, W)) * 0.5]
    states = [rng.standard_normal((B, K, W)) * 0.3 for _ in range(4)]
    (jfb, tfb), (jaw, taw), (jatt, tatt), (ju, tu) = map(_bf16_pair, arrays)
    js, ts = zip(*map(_bf16_pair, states))
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16)
        if a.dtype == np.float32 else jnp.asarray(a), params)
    jc = JaxConfig(width=W, depth=2, voc_size=V)
    tc = Seq2SeqConfig(width=W, depth=2, voc_size=V)
    want = jbeam.beam_decoder_step(
        jparams, jc, jfb, [(js[0], js[1]), (js[2], js[3])], jaw,
        jnp.asarray(astart), jatt, ju)
    got = beam.beam_decoder_step(
        params_from_numpy(params, 'cpu', BF), tc, tfb,
        [(ts[0], ts[1]), (ts[2], ts[3])], taw, torch.from_numpy(astart),
        tatt, tu)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(
        got[2].float().numpy() > 0,
        np.asarray(want[2].astype(jnp.float32)) > 0)
    np.testing.assert_array_equal(
        got[4].numpy(), np.asarray(want[4].astype(jnp.float32)))
    # float32 positions: other windows on some rows
    t0 = (taw.float() * (torch.from_numpy(astart)[..., None].float()
                         + torch.arange(WIN))).sum(dim=-1) + 1.0
    start_f32 = torch.clamp(torch.floor(t0).long() - WW, 0, T - WIN)
    assert (start_f32.numpy() != np.asarray(want[3])).any()
    assert beam._position_dtype(BF, 384) == BF
    assert beam._position_dtype(BF, 256) == torch.float32
    assert beam._position_dtype(torch.float32, 384) == torch.float32


def test_dispatch_bound_at_256(monkeypatch):
    """K1 serves bfloat16 buckets up to 256 and K3 steps bfloat16 beams
    up to 256 (their card-side support patched to hold on the CPU)."""
    tc = Seq2SeqConfig(width=W, depth=2, voc_size=V)
    assert dlk.loop_covers(tc, BF, 256)
    assert not dlk.loop_covers(tc, BF, 257)
    assert not dlk.loop_covers(tc, torch.float32, 64)
    monkeypatch.setattr(beam, 'fused_step_supported', lambda *a: True)
    bf16 = params_from_numpy(_params(), 'cpu', BF)
    f32 = params_from_numpy(_params(), 'cpu')
    assert beam._step_kernel_route(bf16, tc, False, 256)
    assert not beam._step_kernel_route(bf16, tc, False, 257)
    assert not beam._step_kernel_route(f32, tc, False, 64)


def _pair(seed=11):
    pair = []
    for cls, mapping, kw in ((JaxS2S, JaxCharMapping, {}),
                             (Sequence2Sequence, CharMapping,
                              {'device': 'cpu'})):
        s2s = cls(**kw)
        s2s.mapping = mapping.from_texts([CHARS])
        s2s.width, s2s.depth = W, 2
        s2s.configure()
        params = init_params(s2s.config, seed=seed)
        params['char_embedding']['kernel'] *= 400.0
        s2s.params = params
        s2s.status = 2
        s2s.compute = 'bfloat16'
        pair.append(s2s)
    return pair


def _long_lines(rng, n, lo, hi):
    letters = np.array(list(CHARS[:-1]))
    return [''.join(rng.choice(letters, size=rng.integers(lo, hi))) + '\n'
            for _ in range(n)]


def test_long_lines_skip_k1(monkeypatch):
    """bfloat16 greedy serving with K1's support as on a card: a batch of
    short lines goes through K1 (its plain twin here), a batch of 300-400
    characters (the 384 bucket) through the windowed decoder. In float32
    both packages decode those lines alike: equal texts, scores within
    1e-5 (float32 summation order)."""
    monkeypatch.setattr(api, 'fused_greedy_supported', lambda p, c, T:
                        dlk.loop_covers(c, p['char_embedding']['kernel']
                                        .dtype, T))
    calls = []
    for name in ('decode_greedy_fused', 'decode_greedy_windowed'):
        fn = getattr(api, name)
        monkeypatch.setattr(api, name, lambda *a, _fn=fn, _name=name, **kw:
                            calls.append(_name) or _fn(*a, **kw))
    jax_s2s, port = _pair()
    rng = np.random.default_rng(4)
    short = _long_lines(rng, 3, 5, 20)
    long = _long_lines(rng, 3, 300, 400)
    port.correct_lines(short, return_alignments=False)
    assert calls == ['decode_greedy_fused']
    del calls[:]
    port.correct_lines(long, return_alignments=False)
    assert calls == ['decode_greedy_windowed']
    port.compute = jax_s2s.compute = 'float32'
    got, _, got_scores, _ = port.correct_lines(long, return_alignments=False)
    want, _, want_scores, _ = jax_s2s.correct_lines(long,
                                                    return_alignments=False)
    assert got == want
    np.testing.assert_allclose(got_scores, want_scores, atol=1e-5, rtol=0)
