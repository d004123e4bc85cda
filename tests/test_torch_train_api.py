"""PyTorch port: training through the API and the CLI, and model saving.

Mirrors tests/test_api_train.py: a tiny model learns to uppercase
characters (a toy 'correction'), the bulk through direct ``train_step``
calls, then a short ``train()`` pass over the file for the whole loop
(file reading, split, checkpoints, best-weight restore). A model the
port saves is loaded by the JAX package and decodes to the same text.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cor_asv_ann_tpu.models.api import Sequence2Sequence as JaxS2S
from cor_asv_ann_tpu.utils import synthdata as jsynth
from cor_asv_ann_tpu_torch.models import train as T
from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                 params_to_numpy, tree_map)
from cor_asv_ann_tpu_torch.utils import io_h5, synthdata
from cor_asv_ann_tpu_torch.utils.data import vectorize_lines
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = ["abca\n", "cab\n", "bbac\n"]


def _toy_lines(n=192):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(n):
        word = ''.join(rng.choice(list('abc'), rng.integers(2, 6)))
        lines.append(f"{word}\t{word.upper()}")
    return lines


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('train')
    data = tmp / 'train.txt'
    lines = _toy_lines()
    data.write_text('\n'.join(lines) + '\n')

    s2s = Sequence2Sequence(device='cpu')
    s2s.width, s2s.depth, s2s.batch_size = 32, 2, 16
    s2s.dropout = 0.0       # tiny toy model: regularization off
    s2s.map_files([str(data)])
    s2s.configure()

    batches = []
    for lo in range(0, 192, 64):
        srcs = [l.split('\t')[0] + '\n' for l in lines[lo:lo + 64]]
        tgts = [l.split('\t')[1] + '\n' for l in lines[lo:lo + 64]]
        batches.append(vectorize_lines(s2s.mapping, srcs, tgts,
                                       bucketed=False, pad_encoder=8,
                                       pad_decoder=9))
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(s2s.params, 'cpu'))
    opt = T.make_optimizer(params, 1.5e-2)
    for step in range(800):
        T.train_step(params, opt, s2s.config, *batches[step % 3], None)
    s2s.params = params_to_numpy(params)
    s2s.status = 2

    # the whole loop on top (also shows it does not regress the model)
    s2s.epochs = 2
    s2s.learning_rate = 1e-3
    history = s2s.train([str(data)], checkpoint_dir=str(tmp))
    return s2s, history, str(tmp)


def test_training_learns(trained):
    s2s, history, _ = trained
    assert s2s.status == 2
    assert len(history['loss']) == len(history['val_loss']) == 2
    assert history['loss'][-1] < 1.0  # far below the ~1.6 unigram plateau
    out, probs, scores, aligns = s2s.correct_lines(PROBES)
    exact = sum(o == p.upper() for o, p in zip(out, PROBES))
    assert exact >= 2, out
    assert all(0 < p <= 1 for p in probs[0])
    assert len(aligns[0]) == len(out[0])
    assert isinstance(s2s.params['char_embedding']['kernel'], np.ndarray)


def test_train_writes_checkpoints_that_load(trained):
    s2s, history, tmp = trained
    ckpts = sorted(f for f in os.listdir(tmp)
                   if f.startswith('model.ckpt.weights-'))
    assert len(ckpts) == 2 and ckpts[0].startswith('model.ckpt.weights-01-')
    config, mapping = io_h5.load_config(os.path.join(tmp, ckpts[-1]))
    assert config.width == 32 and mapping.c2i == s2s.mapping.c2i
    io_h5.load_weights(os.path.join(tmp, ckpts[-1]), config)
    state = T.load_train_state(tmp)
    assert state['epoch'] == 2 and state['opt_state']['count'] > 0
    assert state['best_loss'] == pytest.approx(min(history['val_loss']))
    assert len(state['split']) == 192


def test_resume_runs_the_remaining_epochs(trained):
    s2s, _, tmp = trained
    again = Sequence2Sequence(device='cpu')
    again.width, again.depth, again.batch_size = 32, 2, 16
    again.dropout = 0.0
    again.epochs = 3
    again.map_files([os.path.join(tmp, 'train.txt')])
    again.configure()
    history = again.train([os.path.join(tmp, 'train.txt')],
                          checkpoint_dir=tmp, resume=True)
    # epochs 1 and 2 came from the checkpoint: only the third is run, and
    # it starts from the trained weights, not from the fresh ones
    assert len(history['loss']) == 1 and history['loss'][0] < 1.0
    assert T.load_train_state(tmp)['epoch'] == 3


def test_saved_model_loads_in_jax_package_and_decodes_alike(trained,
                                                            tmp_path):
    s2s, _, _ = trained
    path = str(tmp_path / 'toy.h5')
    s2s.save(path)
    jax_s2s = JaxS2S()
    jax_s2s.load_config(path)
    jax_s2s.configure()
    jax_s2s.load_weights(path)
    port = Sequence2Sequence(device='cpu')
    port.load_config(path)
    port.configure()
    port.load_weights(path)
    lines = PROBES + ["ab\n", "ccab\n"]
    want, _, want_scores, _ = jax_s2s.correct_lines(lines, fast=True,
                                                    greedy=True)
    for model in (s2s, port):
        got, _, scores, _ = model.correct_lines(lines)
        assert got == want
        np.testing.assert_allclose(scores, want_scores, atol=1e-4)


def test_save_refuses_an_untrained_model():
    s2s = Sequence2Sequence(device='cpu')
    s2s.width, s2s.depth = 8, 2
    s2s.configure()
    with pytest.raises(RuntimeError):
        s2s.save('never-written.h5')
    with pytest.raises(NotImplementedError):
        s2s.correct_lines(["a\n"], greedy=False)


def test_map_files_grows_the_vocabulary_of_a_trained_model(trained,
                                                           tmp_path):
    """New characters in new data: embedding rows follow their characters
    to the new indices, every other weight is kept."""
    s2s, _, _ = trained
    path = str(tmp_path / 'toy.h5')
    s2s.save(path)
    grown = Sequence2Sequence(device='cpu')
    grown.load_config(path)
    grown.configure()
    grown.load_weights(path)
    old_map, old = grown.mapping, grown.params
    old_kernel = old['char_embedding']['kernel'].copy()
    extra = tmp_path / 'extra.txt'
    extra.write_text("abd\tABD\n")
    assert grown.map_files([str(extra)]) == 1
    assert grown.voc_size == old_map.voc_size + 2
    kernel = grown.params['char_embedding']['kernel']
    for char, idx in old_map.c2i.items():
        np.testing.assert_array_equal(kernel[grown.mapping.get(char)],
                                      old_kernel[idx])
    assert grown.params['encoder'] is old['encoder']
    out, _, _, _ = grown.correct_lines(PROBES[:1])
    assert out == s2s.correct_lines(PROBES[:1])[0]


def test_transfer_from_shallower_model_freezes_its_layers(tmp_path):
    donor = Sequence2Sequence(device='cpu')
    donor.width, donor.depth = 8, 1
    donor.mapping = donor.mapping.from_texts(["abc\n"])
    donor.configure()
    donor.status = 2
    path = str(tmp_path / 'donor.h5')
    donor.save(path)
    s2s = Sequence2Sequence(device='cpu')
    s2s.width, s2s.depth = 8, 2
    s2s.configure()
    s2s.load_transfer_weights(path)
    assert s2s.frozen_layers == ['encoder_lstm_1', 'decoder_lstm_1']
    assert s2s.mapping.c2i == donor.mapping.c2i and s2s.status == 1
    np.testing.assert_array_equal(s2s.params['encoder'][0]['fw']['kernel'],
                                  donor.params['encoder'][0]['fw']['kernel'])
    shallow = Sequence2Sequence(device='cpu')
    shallow.depth = 1
    shallow.width = 8
    shallow.configure()
    with pytest.raises(ValueError):
        shallow.load_transfer_weights(path)


def test_gen_lines_and_vectorize_lines_wrappers(trained):
    s2s, _, tmp = trained
    batch = next(iter(s2s.gen_lines([os.path.join(tmp, 'train.txt')],
                                    train=True)))
    sources, _, targets, _ = batch
    assert len(sources) == s2s.batch_size
    enc, dec_in, dec_out, w = s2s.vectorize_lines(sources, targets)
    assert enc.shape[0] == dec_in.shape[0] == s2s.batch_size
    assert enc.shape[2] == s2s.voc_size and w.shape == dec_out.shape[:2]


def test_synthdata_copy_matches():
    assert synthdata.make_pairs(40, seed=3) == jsynth.make_pairs(40, seed=3)
    assert synthdata.WORDS == jsynth.WORDS and synthdata.NOISE == jsynth.NOISE


def test_train_cli_smoke(tmp_path):
    """scripts/train.py end to end on the CPU: trains for the epochs the
    environment names, saves a model that loads."""
    data = tmp_path / 'train.txt'
    data.write_text('\n'.join(_toy_lines(48)) + '\n')
    model = tmp_path / 'toy.h5'
    env = dict(os.environ, PYTHONPATH=ROOT, CORASVANN_TEST_EPOCHS='2',
               OMP_NUM_THREADS='1')
    out = subprocess.run(
        [sys.executable, '-m', 'cor_asv_ann_tpu_torch.scripts.train',
         '-m', str(model), '-w', '8', '-d', '2', '--device', 'cpu',
         '--compute', 'bfloat16', str(data)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    config, mapping = io_h5.load_config(str(model))
    assert (config.width, config.depth) == (8, 2)
    assert set('abcABC\n') <= set(mapping.c2i)
    io_h5.load_weights(str(model), config)
    assert (tmp_path / 'train_state.pkl').exists()
    # without a GPU the default device refuses instead of training slowly
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, '-m', 'cor_asv_ann_tpu_torch.scripts.train',
             '-m', str(model), '-w', '8', str(data)],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0 and 'CUDA' in out.stderr
