"""PyTorch port: serving's encoder on the whole-sequence scan route.

``encode(train=False)`` scans through ``models/seq2seq.py:_sequence_scan``
as training does: ``lstm_scan_fused`` (K4 on CUDA tensors, its plain
version on CPU tensors) where ``_FUSED_SCAN`` takes it, else the
step-by-step ``lstm_scan``. With the route forced 'on' the plain K4 must
give what 'off' gives, at the scan tests' float32 bar (rtol 1e-5 /
atol 1e-6: the logistic written two ways, an ulp apart); 'auto' keeps
CPU tensors on ``lstm_scan`` and launches nothing (on the card it keeps
served bfloat16 scans there too: tests/test_torch_cuda.py); the tracer
counts the encoder's scans and those the fused scan serves; where no
input needs a gradient the fused scan keeps nothing for a backward.
"""

import numpy as np
import pytest
import torch

from cor_asv_ann_tpu_torch.models import seq2seq as S
from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig, init_params
from cor_asv_ann_tpu_torch.models.params import params_from_numpy, tree_map
from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as K
from cor_asv_ann_tpu_torch.utils import profiling
from cor_asv_ann_tpu_torch.utils.data import CharMapping
from padding_masks import padding_mask
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-6)
CHARS = "abcdefghij .,\n"
LINES = ["abba dig.\n", "chef i gad.\n", "hi.\n", "deaf bad cab, jig.\n"]
V = 20

TOPOLOGIES = {
    # the flagship's: a bidirectional first layer, a forward second one
    'flagship': dict(depth=2),
    # every layer bidirectional, with residual connections and bridges
    'deep': dict(depth=3, deep_bidirectional_encoder=True,
                 residual_connections=True, bridge_dense=True),
}


def _model(mask_padding, topology='flagship', seed=3):
    config = Seq2SeqConfig(width=16, voc_size=V, mask_padding=mask_padding,
                           **TOPOLOGIES[topology])
    return config, params_from_numpy(init_params(config, seed=seed), 'cpu')


def _batch(seed=5, B=5, T=9):
    """(B, T) indices with right padding (-1) at random lengths, row 1
    fully padded, row 0 whole."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, V, size=(B, T))
    lengths = rng.integers(1, T + 1, B)
    lengths[0], lengths[1] = T, 0
    idx[np.arange(T)[None] >= lengths[:, None]] = -1
    return torch.from_numpy(idx.astype(np.int64))


def _encode(monkeypatch, mode, config, params, enc, train=False):
    monkeypatch.setattr(S, '_FUSED_SCAN', mode)
    with torch.no_grad():
        return S.encode(params, config, S.ensure_onehot(enc, config, params),
                        train=train)


def _flat(encoded):
    attended, states, u = encoded
    return [attended, u] + [t for hc in states for t in hc]


@pytest.mark.parametrize('topology', sorted(TOPOLOGIES))
@pytest.mark.parametrize('mask_padding', [True, False],
                         ids=['masked', 'unmasked'])
def test_serving_encode_on_equals_off(monkeypatch, topology, mask_padding):
    """attended, the decoder's initial states and u, with right padding
    and a fully padded row: the plain K4 route against the plain scan."""
    config, params = _model(mask_padding, topology)
    enc = _batch()
    on = _encode(monkeypatch, 'on', config, params, enc)
    off = _encode(monkeypatch, 'off', config, params, enc)
    for g, w in zip(_flat(on), _flat(off)):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)
    if mask_padding:
        # the fully padded row's outputs are zero on both routes
        assert not bool(on[0][1].any()) and not bool(off[0][1].any())


@pytest.mark.parametrize('with_init', [False, True])
def test_reverse_masked_scan_on_equals_off(monkeypatch, with_init):
    """The bidirectional layer's reverse scan on its own, with a mask of
    right padding, a whole row, a fully padded row and gaps, with and
    without an initial state."""
    rng = np.random.default_rng(17)
    B, T, D, N = 6, 8, 12, 16
    w = {'kernel': rng.standard_normal((D, 4 * N)) * 0.3,
         'recurrent_kernel': rng.standard_normal((N, 4 * N)) * 0.3,
         'bias': rng.standard_normal(4 * N) * 0.1}
    w = {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}
    xs = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    h0 = c0 = None
    if with_init:
        h0, c0 = (torch.from_numpy(
            rng.standard_normal((B, N)).astype(np.float32) * 0.2)
            for _ in range(2))
    mask = torch.from_numpy(padding_mask(B, T, 23))
    got = {}
    for mode in ('on', 'off'):
        monkeypatch.setattr(S, '_FUSED_SCAN', mode)
        with torch.no_grad():
            got[mode] = S._sequence_scan(xs, w, h0, c0, reverse=True,
                                         mask=mask)
    for g, r in zip(got['on'], got['off']):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **F32)
    assert not bool(got['on'][0][~mask].any())


def test_auto_on_cpu_launches_nothing_and_keeps_lstm_scan(monkeypatch):
    """'auto' on CPU tensors: every scan of the encoder through
    `lstm_scan`, none through `lstm_scan_fused`, no kernel launch."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(S, name, wrapped)

    spy('lstm_scan', S.lstm_scan)
    spy('lstm_scan_fused', S.lstm_scan_fused)
    config, params = _model(True)
    before = K.lstm_scan_fwd.launches
    _encode(monkeypatch, 'auto', config, params, _batch())
    assert calls == ['lstm_scan'] * 3
    assert K.lstm_scan_fwd.launches == before


def _counted(fn):
    from torch.profiler import ProfilerActivity, profile
    profiling.snapshot()    # the tracer sees no session: the next starts empty
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    counters = profiling.snapshot()['counters']
    return (counters.get('decoders.encoder_scans', 0),
            counters.get('decoders.encoder_kernel_scans', 0))


@pytest.mark.parametrize('mode,want', [('on', (3, 3)), ('off', (3, 0)),
                                       ('auto', (3, 0))])
def test_encoder_counters_under_the_tracer(monkeypatch, mode, want):
    """The flagship topology's three scans, and those the fused scan
    serves ('auto' on CPU tensors: none)."""
    config, params = _model(True)
    enc = _batch()
    assert _counted(lambda: _encode(monkeypatch, mode, config, params,
                                    enc)) == want


def test_training_encode_is_not_counted(monkeypatch):
    config, params = _model(True)
    enc = _batch()
    assert _counted(lambda: _encode(monkeypatch, 'on', config, params, enc,
                                    train=True)) == (0, 0)


def test_no_gradient_saves_nothing_and_outputs_stay_views():
    """Without a gradient to take, `lstm_scan_fused` returns outputs that
    hold no autograd node and are views of the scan's (T+1, B, N) state
    buffer; with one it still goes through `LstmScan`."""
    config, params = _model(True)
    w = params['encoder'][1]
    B, T = 4, 7
    xs = torch.randn(B, T, w['kernel'].shape[0],
                     generator=torch.Generator().manual_seed(2))
    mask = torch.from_numpy(padding_mask(B, T, 4))
    served = K.lstm_scan_fused(xs, w, mask=mask)
    assert all(t.grad_fn is None for t in served)
    assert served[0]._base is not None
    assert served[0]._base.shape == (T + 1, B, 16)
    leaves = tree_map(lambda t: t.clone().requires_grad_(), w)
    trained = K.lstm_scan_fused(xs, leaves, mask=mask)
    scan_node = trained[0].grad_fn.next_functions[0][0]
    assert type(scan_node).__name__.startswith('LstmScanBackward')
    for g, r in zip(served, trained):
        np.testing.assert_array_equal(g.numpy(), r.detach().numpy())
    with torch.no_grad():
        assert K.lstm_scan_fused(xs, leaves, mask=mask)[0].grad_fn is None


def _tiny_s2s():
    """A tiny masked model (width 8, depth 2, peaked readout) on the
    CPU, as the API serves it."""
    s2s = Sequence2Sequence(device='cpu')
    s2s.mapping = CharMapping.from_texts([CHARS])
    s2s.width, s2s.depth = 8, 2
    s2s.configure()
    params = init_params(s2s.config, seed=7)
    params['char_embedding']['kernel'] *= 400.0
    s2s.params = params
    s2s.status = 2
    return s2s


@pytest.mark.parametrize('greedy', [True, False], ids=['greedy', 'beam'])
def test_correct_lines_on_equals_off(monkeypatch, greedy):
    """The API's greedy and beam decodes over the plain K4 route: the
    same texts, scores at the float32 bar."""
    s2s = _tiny_s2s()
    assert s2s.config.mask_padding
    got = {}
    for mode in ('on', 'off'):
        monkeypatch.setattr(S, '_FUSED_SCAN', mode)
        got[mode] = s2s.correct_lines(list(LINES), fast=greedy,
                                      greedy=greedy,
                                      return_alignments=False)
    assert got['on'][0] == got['off'][0]
    np.testing.assert_allclose(got['on'][2], got['off'][2], rtol=1e-5,
                               atol=1e-5)
