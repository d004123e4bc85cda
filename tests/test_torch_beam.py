"""PyTorch port: the beam search (models/beam.py) against the JAX package's.

The tiny models, lines and seeds of tests/test_beam.py go through
``beam_decoder_step`` and ``decode_beam`` of both packages, the port on
both routes of its step: per-op ('off') and through the plain version of
the fused decode-step kernel K3 ('on', float32, on the CPU). The search
is discrete, so indices, lengths and counts must be equal; costs within
1e-4 and soft alignment rows within 1e-5 (float32 summation order of two
libraries over at most 24 steps; measured 2e-6 and 3e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cor_asv_ann_tpu.lib import numpy_ref
from cor_asv_ann_tpu.models import beam as jbeam
from cor_asv_ann_tpu.models import seq2seq as jseq2seq
from cor_asv_ann_tpu.models.config import Seq2SeqConfig as JaxConfig
from cor_asv_ann_tpu.models.config import init_params
from cor_asv_ann_tpu.utils.data import CharMapping
from cor_asv_ann_tpu_torch.models import beam
from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig
from cor_asv_ann_tpu_torch.models.params import params_from_numpy
from cor_asv_ann_tpu_torch.models.seq2seq import encode

from conftest import make_onehot_batch
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

LINES = ["abba dig.\n", "chef i gad.\n", "hi.\n"]
T = 12
SEEDS = [(7, 2), (11, 2), (23, 2), (3, 2), (5, 2), (13, 2), (31, 2),
         (42, 2), (7, 1), (11, 3)]
MAPPING = CharMapping.from_texts(["abcdefghij .,\n"])
NL = MAPPING.get('\n')
ORACLE_BOUNDS = dict(reservoir=192, expand=8, beam_width_in=6,
                     beam_width_out=4)


def _model(seed, depth=2, sharpen=True, **kw):
    """(numpy params, JAX config, port config) of a tiny model; `sharpen`
    makes its readout peaked like tests/test_beam.py does."""
    jc = JaxConfig(width=8, depth=depth, voc_size=MAPPING.voc_size, **kw)
    params = init_params(jc, seed=seed)
    if sharpen:
        params['char_embedding']['kernel'] *= 400.0
    return params, jc, Seq2SeqConfig(width=8, depth=depth,
                                     voc_size=MAPPING.voc_size, **kw)


def _route(mode):
    """Context: the port's step route for the body."""
    class Route:
        def __enter__(self):
            beam._BEAM_STEP_KERNEL = mode

        def __exit__(self, *exc):
            beam._BEAM_STEP_KERNEL = 'auto'
    return Route()


def _np(out):
    return {k: (v.float().numpy() if v.is_floating_point() else v.numpy())
            for k, v in out.items() if k != 'trace'}


def _decode_both(params, jc, tc, bounds, lines, src_len, mode='off',
                 dtype=None, **kw):
    enc = make_onehot_batch(MAPPING, lines, pad_to=T)
    want = {k: np.asarray(v) for k, v in jbeam.decode_beam(
        params, jc, jbeam.BeamParams(**bounds), enc, NL, src_len,
        **kw).items() if k != 'trace'}
    with _route(mode):
        got = beam.decode_beam(params_from_numpy(params, 'cpu', dtype), tc,
                               beam.BeamParams(**bounds),
                               torch.from_numpy(enc), NL, src_len, **kw)
    return _np(got), want


def _assert_same_search(got, want, aligns=False):
    for key in ('idx', 'length', 'count', 'align_pos'):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ('cost', 'cum'):
        finite = np.isfinite(want[key])
        np.testing.assert_array_equal(np.isfinite(got[key]), finite)
        np.testing.assert_allclose(got[key][finite], want[key][finite],
                                   atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got['prob'], want['prob'], atol=1e-5)
    if aligns:
        np.testing.assert_array_equal(got['align_start'],
                                      want['align_start'])
        np.testing.assert_allclose(got['align_row'], want['align_row'],
                                   atol=1e-5)


@pytest.mark.parametrize('seed,depth', SEEDS)
def test_decode_beam_matches_jax(seed, depth):
    """Every seed and depth of tests/test_beam.py, with alignments; depth
    2 on both routes of the step."""
    params, jc, tc = _model(seed, depth)
    src_len = np.full(len(LINES), T, np.int32)
    for mode in ('off', 'on') if depth == 2 else ('off',):
        got, want = _decode_both(params, jc, tc, ORACLE_BOUNDS, LINES,
                                 src_len, mode, return_alignments=True)
        _assert_same_search(got, want, aligns=True)


@pytest.mark.parametrize('case', ['lm_predict', 'mask_padding', 'rejection0',
                                  'untrained_r05', 'narrow'])
def test_decode_beam_variants_match_jax(case):
    """The LM readout, a padding mask with true source lengths, no
    rejection, an untrained model at rejection 0.5 (long rejection
    chains) and expand > reservoir."""
    bounds = dict(reservoir=32, expand=8, beam_width_in=6, beam_width_out=4)
    kw, sharpen = {}, True
    src_len = np.array([len(l) for l in LINES], np.int32)
    if case == 'lm_predict':
        bounds['lm_predict'] = True
    elif case == 'mask_padding':
        kw['mask_padding'] = True
    elif case == 'rejection0':
        bounds['rejection_threshold'] = 0.0
    elif case == 'untrained_r05':
        bounds.update(reservoir=48, rejection_threshold=0.5)
        sharpen = False
    else:
        bounds.update(reservoir=8, expand=48)
    params, jc, tc = _model(0 if case == 'untrained_r05' else 7,
                            sharpen=sharpen, **kw)
    got, want = _decode_both(params, jc, tc, bounds, LINES, src_len)
    _assert_same_search(got, want)
    if case != 'lm_predict':
        got, _ = _decode_both(params, jc, tc, bounds, LINES, src_len, 'on')
        _assert_same_search(got, want)


@pytest.mark.parametrize('seed,depth', SEEDS)
def test_return_trace_matches_jax(seed, depth):
    """The records `_iteration` writes at the device's t (the trie's and
    the trace's), the final reservoir, the bank and the results, against
    the JAX search's, on every seed and depth of tests/test_beam.py."""
    params, jc, tc = _model(seed, depth)
    bounds = dict(reservoir=32, expand=8, beam_width_in=6, beam_width_out=4)
    enc = make_onehot_batch(MAPPING, LINES, pad_to=T)
    src_len = np.full(len(LINES), T, np.int32)
    want_out = jbeam.decode_beam(params, jc, jbeam.BeamParams(**bounds), enc,
                                 NL, src_len, return_trace=True)
    got_out = beam.decode_beam(params_from_numpy(params, 'cpu'), tc,
                               beam.BeamParams(**bounds),
                               torch.from_numpy(enc), NL, src_len,
                               return_trace=True)
    _assert_same_search(_np(got_out), {k: np.asarray(v) for k, v in
                                       want_out.items() if k != 'trace'})
    want, got = want_out['trace'], got_out['trace']
    assert set(got) == set(want)
    assert got['t'] == int(want['t'])
    steps = got['t']
    for key in ('rec_parent', 'rec_char', 'rec_exp', 'rec_cidx',
                'rec_cvalid', 'rec_srcpos', 'rec_rejok'):
        np.testing.assert_array_equal(got[key][:, :steps].numpy(),
                                      np.asarray(want[key])[:, :steps],
                                      err_msg=key)
    for key in ('rec_cp', 'rec_misal', 'rec_rejp'):
        np.testing.assert_allclose(got[key][:, :steps].numpy(),
                                   np.asarray(want[key])[:, :steps],
                                   atol=1e-5, err_msg=key)
    for key in ('nchars', 'is_fin'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ('pro', 'cum'):
        finite = np.isfinite(np.asarray(want[key]))
        np.testing.assert_array_equal(np.isfinite(got[key].numpy()), finite)
        np.testing.assert_allclose(got[key].numpy()[finite],
                                   np.asarray(want[key])[finite], atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize('depth,with_lm,mask_padding',
                         [(1, False, False), (2, False, True),
                          (2, True, False), (3, True, True)])
def test_beam_decoder_step_matches_jax(depth, with_lm, mask_padding):
    """One step on a carried window state, per-op route, within 2e-5."""
    params, jc, tc = _model(5, depth, sharpen=False,
                            mask_padding=mask_padding)
    rng = np.random.default_rng(depth)
    B, K, W, V = len(LINES), 4, 8, MAPPING.voc_size
    WIN = min(2 * jc.window_width + 2, T)
    enc = make_onehot_batch(MAPPING, LINES, pad_to=T)
    fb = rng.uniform(0, 1, (B, K, V)).astype(np.float32)
    states = [(rng.normal(0, .5, (B, K, W)).astype(np.float32),
               rng.normal(0, .5, (B, K, W)).astype(np.float32))
              for _ in range(depth)]
    aw = rng.uniform(0, 1, (B, K, WIN)).astype(np.float32)
    aw /= aw.sum(axis=-1, keepdims=True)
    astart = rng.integers(0, 3, (B, K)).astype(np.int32)
    lengths = np.array([len(l) for l in LINES], np.int32)
    attended, _, u = jseq2seq.encode(params, jc, enc)
    want = jbeam.beam_decoder_step(
        params, jc, fb, states, aw, astart, attended, u, with_lm=with_lm,
        src_lengths=jnp.asarray(lengths) if mask_padding else None)
    tparams = params_from_numpy(params, 'cpu')
    t_att, _, t_u = encode(tparams, tc, torch.from_numpy(enc))
    with _route('off'):
        got = beam.beam_decoder_step(
            tparams, tc, torch.from_numpy(fb),
            [tuple(torch.from_numpy(x) for x in hc) for hc in states],
            torch.from_numpy(aw), torch.from_numpy(astart), t_att, t_u,
            with_lm=with_lm,
            src_lengths=torch.from_numpy(lengths) if mask_padding else None)
    assert len(got) == len(want) == (6 if with_lm else 5)
    flat_got = [got[0], *[x for hc in got[1] for x in hc], *got[2:]]
    flat_want = [want[0], *[x for hc in want[1] for x in hc], *want[2:]]
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_top_k_breaks_ties_by_index():
    """Two equal candidates, many dead slots: the order of
    ``jax.lax.top_k`` (lowest index first), which ``torch.topk`` does
    not promise."""
    x = np.full((3, 40), -np.inf, np.float32)
    x[0, [5, 17, 29]] = [-2.0, -1.0, -1.0]
    x[1, [39, 0]] = -0.5
    x[2, :] = 0.30000001192092896          # all clamped to one threshold
    x[2, 7] = 0.9
    want_v, want_i = jax.lax.top_k(x, 8)
    got_v, got_i = beam._top_k(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[0, :5].tolist() == [17, 29, 5, 0, 1]


def test_beam_properties():
    params, _, tc = _model(7)
    enc = make_onehot_batch(MAPPING, LINES + [""], pad_to=T)
    src_len = np.array([len(l) for l in LINES] + [0], np.int32)
    bp = beam.BeamParams(reservoir=32, expand=8, beam_width_in=6,
                         beam_width_out=4)
    out = _np(beam.decode_beam(params_from_numpy(params, 'cpu'), tc, bp,
                               torch.from_numpy(enc), NL, src_len))
    for j in range(len(LINES)):
        n = out['count'][j]
        assert 1 <= n <= 4
        # the bank is ordered best-first by prospective cost
        assert np.all(np.diff(out['cost'][j, :n]) >= -1e-6)
        for f in range(n):
            L = out['length'][j, f]
            assert out['idx'][j, f, L - 1] == NL   # every solution ends in \n
            assert np.all(out['align_pos'][j, f, :L] < T)
    # an empty line produces no solutions
    assert out['count'][len(LINES)] == 0


def _text(out, j, f=0):
    L = out['length'][j, f]
    return ''.join(MAPPING.i2c[int(i)] for i in out['idx'][j, f, :L])


def test_beam_rejection_echoes_input():
    """With an untrained model the rejection mechanism keeps the
    copy-input path alive, so decoding echoes the source."""
    params, _, tc = _model(0, sharpen=False)
    enc = make_onehot_batch(MAPPING, ["abba dig.\n"], pad_to=T)
    bp = beam.BeamParams(reservoir=48, expand=8, beam_width_in=6,
                         beam_width_out=4, rejection_threshold=0.5)
    out = _np(beam.decode_beam(params_from_numpy(params, 'cpu'), tc, bp,
                               torch.from_numpy(enc), NL,
                               np.array([T], np.int32)))
    assert "abba dig.\n" in [_text(out, 0, f) for f in range(out['count'][0])]


def test_beam_soft_alignments_match_oracle():
    """The per-step soft alignment rows (one-hot for rejection steps, raw
    attention rows otherwise) against the reference-semantics numpy
    oracle's node alignments, as tests/test_beam.py holds the JAX beam."""
    params, jc, tc = _model(7)
    enc = make_onehot_batch(MAPPING, LINES, pad_to=T)
    out = _np(beam.decode_beam(
        params_from_numpy(params, 'cpu'), tc,
        beam.BeamParams(**ORACLE_BOUNDS), torch.from_numpy(enc), NL,
        np.full(len(LINES), T, np.int32), return_alignments=True))
    for j in range(len(LINES)):
        gen = numpy_ref.decode_sequence_beam(
            params, jc.as_dict(), MAPPING, enc[j], rejection_threshold=0.3,
            beam_width_in=6, beam_threshold_in=0.2, beam_width_out=4,
            batch_size=8)
        ref_txt, _, _, ref_aligns = next(gen)
        assert _text(out, j) == ref_txt
        rows, starts = out['align_row'][j, 0], out['align_start'][j, 0]
        for step in range(out['length'][j, 0]):
            dense = np.zeros(T, np.float32)
            start = int(starts[step])
            n = min(rows.shape[-1], T - start)
            dense[start:start + n] = rows[step, :n]
            np.testing.assert_allclose(
                dense, np.asarray(ref_aligns[step], np.float32).reshape(-1),
                atol=5e-3, err_msg='line %d step %d' % (j, step))


@pytest.mark.parametrize('mode', ['off', 'on'])
def test_bf16_keeps_float32_bookkeeping(mode):
    """Under bfloat16 parameters costs and the bank stay float32, the
    states and recorded probabilities bfloat16, and on this peaked model
    the 1-best texts equal the float32 decode's with costs within 5e-3
    of it (bfloat16's 3 significant digits on a -log p sum of ~10)."""
    params, jc, tc = _model(7)
    bounds = dict(reservoir=32, expand=8, beam_width_in=6, beam_width_out=4)
    src_len = np.array([len(l) for l in LINES], np.int32)
    enc = torch.from_numpy(make_onehot_batch(MAPPING, LINES, pad_to=T))
    with _route(mode):
        low = beam.decode_beam(
            params_from_numpy(params, 'cpu', torch.bfloat16), tc,
            beam.BeamParams(**bounds), enc, NL, src_len)
    full = beam.decode_beam(params_from_numpy(params, 'cpu'), tc,
                            beam.BeamParams(**bounds), enc, NL, src_len)
    assert low['cost'].dtype == low['cum'].dtype == torch.float32
    assert low['prob'].dtype == torch.bfloat16
    assert torch.equal(low['length'][:, 0], full['length'][:, 0])
    assert torch.equal(low['idx'][:, 0], full['idx'][:, 0])
    torch.testing.assert_close(low['cum'][:, 0], full['cum'][:, 0],
                               atol=5e-3, rtol=0)


def test_step_kernel_flag():
    """'on' raises for a model the fused step does not cover; 'auto' and
    'off' keep CPU tensors on the per-op route."""
    from cor_asv_ann_tpu_torch.ops.decode_step_kernel import fused_decode_step
    params, _, tc = _model(11, depth=3)
    tparams = params_from_numpy(params, 'cpu')
    with _route('on'):
        with pytest.raises(ValueError, match='depth 2'):
            beam._step_kernel_route(tparams, tc, False)
    params, _, tc = _model(11, depth=2)
    tparams = params_from_numpy(params, 'cpu', torch.bfloat16)
    for mode, want in (('off', False), ('auto', False), ('on', True)):
        with _route(mode):
            assert beam._step_kernel_route(tparams, tc, False) is want
    assert fused_decode_step.launches == 0


# the graph route (`beam._BEAM_GRAPH`): on the CPU its 'buffers' stand-in
# runs the route's static inputs and state, loads, copies, clones and
# cache, with each replay run op by op in place of a CUDA graph
OTHER_LINES = ["gag.\n", "deaf cab.\n", "ice, hi.\n"]
GRAPH_CASES = {'plain': {}, 'alignments': {}, 'lm_predict': {},
               'mask_padding': dict(mask_padding=True), 'k3': {},
               'depth3': {}}


@pytest.fixture
def graphs(monkeypatch):
    """An empty cache of the graph route, and the route's stand-in."""
    monkeypatch.setattr(beam, '_GRAPHS', beam._GraphCache())
    monkeypatch.setattr(beam, '_BEAM_GRAPH', 'buffers')
    return beam._GRAPHS


def _call(params, tc, bp, lines, mode='off', **kw):
    enc = torch.from_numpy(make_onehot_batch(MAPPING, lines, pad_to=T))
    src_len = np.array([len(line) for line in lines], np.int32)
    with _route(mode):
        return beam.decode_beam(params, tc, bp, enc, NL, src_len, **kw)


def _assert_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def _graph_case(case):
    bounds = dict(reservoir=32, expand=8, beam_width_in=6, beam_width_out=4,
                  lm_predict=case == 'lm_predict')
    params, _, tc = _model(7, 3 if case == 'depth3' else 2,
                           **GRAPH_CASES[case])
    return (params_from_numpy(params, 'cpu'), tc, beam.BeamParams(**bounds),
            'on' if case == 'k3' else 'off',
            dict(return_alignments=case in ('alignments', 'mask_padding')))


@pytest.mark.parametrize('case', list(GRAPH_CASES))
def test_graph_route_buffers_equal_eager(graphs, monkeypatch, case):
    """Two calls under one key with other inputs each equal a fresh call
    of the eager route, bit for bit, and the first call's results are
    unchanged by the second (none is a view of the route's buffers)."""
    tparams, tc, bp, mode, kw = _graph_case(case)
    first = _call(tparams, tc, bp, LINES, mode, **kw)
    kept = {k: v.clone() for k, v in first.items()}
    second = _call(tparams, tc, bp, OTHER_LINES, mode, **kw)
    assert len(graphs._entries) == 1
    monkeypatch.setattr(beam, '_BEAM_GRAPH', 'off')
    _assert_equal(first, _call(tparams, tc, bp, LINES, mode, **kw))
    _assert_equal(second, _call(tparams, tc, bp, OTHER_LINES, mode, **kw))
    _assert_equal(first, kept)


def test_graph_route_counts_replays_and_a_busy_entry_runs_eager(graphs):
    """Under the tracer each iteration the route serves counts in
    ``decoders.beam_graph_iterations``; a call that finds its key's entry
    held by another runs eager, counts none there, and gives the same
    results. A call with `return_trace` runs eager and makes no entry."""
    from torch.profiler import ProfilerActivity, profile
    from cor_asv_ann_tpu_torch.utils import profiling
    tparams, tc, bp, mode, kw = _graph_case('plain')
    beam._BEAM_GRAPH = 'off'
    want = _call(tparams, tc, bp, LINES, **kw)
    beam._BEAM_GRAPH = 'buffers'
    traced = _call(tparams, tc, bp, LINES, return_trace=True, **kw)
    assert not graphs._entries
    runs = {}
    for name in ('route', 'busy'):
        entry = next(iter(graphs._entries.values()), None)
        if name == 'busy':
            assert entry.lock.acquire(blocking=False)
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                runs[name] = _call(tparams, tc, bp, LINES, **kw)
            # read after the session, which the tracer then sees end
            counters = profiling.snapshot()['counters']
        finally:
            if name == 'busy':
                entry.lock.release()
        _assert_equal(runs[name], want)
        assert counters['decoders.beam_iterations'] == traced['trace']['t']
        assert 'decoders.beam_graph_captures' not in counters
        assert counters.get('decoders.beam_graph_iterations', 0) == (
            counters['decoders.beam_iterations'] if name == 'route' else 0)
    assert len(graphs._entries) == 1


def test_graph_route_evicts_the_least_recently_used(graphs, monkeypatch):
    """Under a budget that holds the entries of the last two of three
    keys (the bank's width), the first key is evicted, then made again
    in place of the second; the cache's bytes are its entries'; every
    call equals the eager route's."""
    tparams, tc, _, _, _ = _graph_case('plain')
    bps = [beam.BeamParams(reservoir=32, expand=8, beam_width_in=6,
                           beam_width_out=n) for n in (2, 3, 4, 2)]
    for bp in bps[:3]:
        _call(tparams, tc, bp, LINES)
    sizes = [entry.nbytes for entry in graphs._entries.values()]
    assert graphs.nbytes == sum(sizes) and sizes[0] < sizes[1] < sizes[2]
    graphs.clear()
    assert graphs.nbytes == 0 and not graphs._entries
    graphs.max_bytes = sizes[1] + sizes[2]
    outs = [_call(tparams, tc, bp, LINES) for bp in bps]
    assert [next(x for x in key if isinstance(x, beam.BeamParams))
            for key in graphs._entries] == [bps[2], bps[0]]
    assert graphs.nbytes == sizes[2] + sizes[0]
    monkeypatch.setattr(beam, '_BEAM_GRAPH', 'off')
    for bp, got in zip(bps, outs):
        _assert_equal(got, _call(tparams, tc, bp, LINES))


def test_graph_route_runs_a_key_past_its_budget_eager(graphs, monkeypatch):
    """A key whose static buffers alone pass the cache's budget makes no
    entry, evicts none, and its call equals the eager route's."""
    tparams, tc, bp, _, _ = _graph_case('plain')
    wide = beam.BeamParams(reservoir=32, expand=8, beam_width_in=6,
                           beam_width_out=3)
    _call(tparams, tc, bp, LINES)
    (entry,) = graphs._entries.values()
    graphs.max_bytes = entry.nbytes
    got = _call(tparams, tc, bp, OTHER_LINES, return_alignments=True)
    assert list(graphs._entries.values()) == [entry]
    assert graphs.nbytes == entry.nbytes
    _call(tparams, tc, wide, LINES)
    assert len(graphs._entries) == 1 and entry not in graphs._entries.values()
    monkeypatch.setattr(beam, '_BEAM_GRAPH', 'off')
    _assert_equal(got, _call(tparams, tc, bp, OTHER_LINES,
                             return_alignments=True))


def test_graph_route_under_threads(graphs):
    """More threads than cores serve two keys at once, with a short
    switch interval: every result equals the eager route's (a thread
    that finds its key's entry held runs eager)."""
    import os
    import sys
    import threading
    tparams, tc, bp, _, _ = _graph_case('plain')
    wide = beam.BeamParams(reservoir=32, expand=8, beam_width_in=6,
                           beam_width_out=3)
    cases = [(bp, LINES), (bp, OTHER_LINES), (wide, LINES)]
    beam._BEAM_GRAPH = 'off'
    want = [_call(tparams, tc, b, lines) for b, lines in cases]
    beam._BEAM_GRAPH = 'buffers'
    errors = []

    def work(n):
        try:
            for i in range(4):
                c = (n + i) % len(cases)
                got = _call(tparams, tc, *cases[c])
                for key in want[c]:
                    if not torch.equal(got[key], want[c][key]):
                        errors.append((n, i, key))
        except Exception as exc:  # reported by the assertion below
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(n,))
                   for n in range((os.cpu_count() or 4) + 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:5]
    assert len(graphs._entries) == 2
