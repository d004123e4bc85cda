"""Faults planted under the timed path, for the readings that show the
comparison catches them (``portbench/control.py --fault``, and the tests
at a test's size). Each takes a pytest-style `monkeypatch` (an object
with ``setattr(target, name, value)``) and breaks the program where the
work is produced:

- ``stale_state``: the beam's decoder step returns its input states;
- ``half_the_lines``: every other line of a batch gets no solution from
  the beam (the API then echoes its input);
- ``altered_token``: the first character of each served line is
  replaced where the text is made;
- ``beam_of_one``: the beam keeps and expands one hypothesis a line
  (a greedy search with rejection);
- ``page_unwritten``: the processor writes nothing back into the page
  (no realignment, no re-segmenting);
- ``diagonal_path``: the processor realigns by the diagonal instead of
  the Viterbi path of the alignment;
- ``unchanged_state``: the optimizer's step leaves the parameters and
  its state as they were;
- ``half_the_batch``: the training loss is the mean over the first half
  of the batch's lines.
"""


def stale_state(monkeypatch):
    from cor_asv_ann_tpu_torch.models import beam
    step = beam.beam_decoder_step

    def stale(params, config, feedback, layer_states, *args, **kwargs):
        out = step(params, config, feedback, layer_states, *args, **kwargs)
        return (out[0], tuple(layer_states)) + tuple(out[2:])
    monkeypatch.setattr(beam, 'beam_decoder_step', stale)


def half_the_lines(monkeypatch):
    from cor_asv_ann_tpu_torch.models import api
    decode = api.decode_beam

    def half(*args, **kwargs):
        out = decode(*args, **kwargs)
        out['count'][::2] = 0
        return out
    monkeypatch.setattr(api, 'decode_beam', half)


def altered_token(monkeypatch):
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    to_text = Sequence2Sequence._indexes2text

    def altered(self, indexes):
        text = to_text(self, indexes)
        if len(text) > 1:
            text = ('a' if text[0] != 'a' else 'e') + text[1:]
        return text
    monkeypatch.setattr(Sequence2Sequence, '_indexes2text', altered)


def beam_of_one(monkeypatch):
    import dataclasses
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    params = Sequence2Sequence._beam_params

    def one(self, confidence=None):
        return dataclasses.replace(params(self, confidence), reservoir=1,
                                   expand=1)
    monkeypatch.setattr(Sequence2Sequence, '_beam_params', one)


def page_unwritten(monkeypatch):
    from cor_asv_ann_tpu_torch.wrapper.transcode import ANNCorrection
    monkeypatch.setattr(ANNCorrection, '_apply_page',
                        lambda self, doc, *args: doc)


def diagonal_path(monkeypatch):
    from cor_asv_ann_tpu_torch.wrapper import transcode

    def diagonal(alignment, i_max, j_max, min_score):
        path = {i: min(i, j_max) for i in range(i_max)}
        path[i_max] = j_max
        return path, 0.0
    monkeypatch.setattr(transcode, '_alignment2path', diagonal)


def unchanged_state(monkeypatch):
    from cor_asv_ann_tpu_torch.models import train
    make = train.make_optimizer

    def frozen(params, learning_rate=1e-3):
        opt = make(params, learning_rate)
        opt.step = lambda *a, **k: None
        return opt
    monkeypatch.setattr(train, 'make_optimizer', frozen)


def half_the_batch(monkeypatch):
    from cor_asv_ann_tpu_torch.models import train
    xent = train.weighted_xent

    def half(probs, targets, weights, denom=None):
        n = probs.shape[0] // 2
        return xent(probs[:n], targets[:n], weights[:n])
    monkeypatch.setattr(train, 'weighted_xent', half)


PAGES = ('stale_state', 'half_the_lines', 'altered_token', 'beam_of_one',
         'page_unwritten', 'diagonal_path')
TRAIN = ('unchanged_state', 'half_the_batch')


class Patch:
    """A minimal ``monkeypatch`` for a script: `undo` restores."""

    def __init__(self):
        self.saved = []

    def setattr(self, target, name, value):
        self.saved.append((target, name, getattr(target, name)))
        setattr(target, name, value)

    def undo(self):
        while self.saved:
            target, name, value = self.saved.pop()
            setattr(target, name, value)
