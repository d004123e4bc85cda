"""PyTorch port: the native edit-ops library and the edit-distance chain.

Counterparts of tests/test_native.py for the port's copy of
``lib/native.py``, which builds ``libeditops.so`` from the port's own
``native/`` sources with make on first use; its results equal the JAX
package's library, and the port's ``lib/alignment.py`` takes the JAX
package's chain of backends: rapidfuzz, then native, then Python.
"""

import os
import sys

import numpy as np
import pytest

from cor_asv_ann_tpu.lib import alignment as jax_alignment
from cor_asv_ann_tpu.lib import native as jax_native
from cor_asv_ann_tpu_torch.lib import alignment
from cor_asv_ann_tpu_torch.lib import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason='native library not buildable')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lev_distance():
    assert native.lev_distance('kitten', 'sitting') == 3
    assert native.lev_distance('', 'abc') == 3
    assert native.lev_distance('abc', 'abc') == 0
    assert native.lev_distance('Straße', 'Strasse') == 2


def test_lev_distance_batch():
    pairs = [('kitten', 'sitting'), ('abc', 'abc'), ('', 'xy')]
    assert native.lev_distance_batch(pairs) == [3, 0, 2]


def test_lev_matches_python():
    cases = [('Der Hvnd', 'Der Hund'), ('aͤb', 'äb'), ('x' * 50, 'y' * 30)]
    for a, b in cases:
        assert native.lev_distance(a, b) == alignment._levenshtein(a, b)


def test_nw_align_pairs():
    pairs = native.nw_align('abcd', 'abxd')
    assert pairs == [('a', 'a'), ('b', 'b'), ('c', 'x'), ('d', 'd')]
    pairs = native.nw_align('abd', 'abcd')
    assert (0, 'c') in pairs
    # distance along the path equals Levenshtein
    dist = sum(1 for s, t in native.nw_align('kitten', 'sitting')
               if s != t)
    assert dist == 3


def test_library_is_the_ports_own():
    """The port builds and loads the library from its own sources."""
    here = os.path.join(ROOT, 'cor_asv_ann_tpu_torch', 'native')
    assert native._NATIVE_DIR == here
    assert native._LIB_PATH == os.path.join(here, 'libeditops.so')
    assert os.path.exists(native._LIB_PATH)
    for name in ('editops.cpp', 'Makefile'):
        with open(os.path.join(here, name), 'rb') as f:
            port = f.read()
        with open(os.path.join(ROOT, 'cor_asv_ann_tpu', 'native', name),
                  'rb') as f:
            ref = f.read()
        if name == 'Makefile':
            assert port == ref
        else:
            # the same code; only the comment naming the package differs
            assert port.replace(b'cor_asv_ann_tpu_torch',
                                b'cor_asv_ann_tpu') == ref


def _random_pairs(seed, n):
    rng = np.random.default_rng(seed)
    chars = list('abcde ſäͤ')
    return [(''.join(rng.choice(chars, rng.integers(0, 40))),
             ''.join(rng.choice(chars, rng.integers(0, 40))))
            for _ in range(n)]


@pytest.mark.skipif(not jax_native.available(),
                    reason='the JAX package\'s native library not buildable')
@pytest.mark.parametrize('seed', range(3))
def test_matches_jax_library(seed):
    pairs = _random_pairs(seed, 50)
    assert native.lev_distance_batch(pairs) == \
        jax_native.lev_distance_batch(pairs)
    for a, b in pairs:
        assert native.lev_distance(a, b) == jax_native.lev_distance(a, b)
        assert native.nw_align(a, b) == jax_native.nw_align(a, b)


def test_alignment_chain_uses_native_without_rapidfuzz(monkeypatch):
    """Without rapidfuzz the Levenshtein-fast distance goes through the
    native library (not pure Python), as in the JAX package."""
    monkeypatch.setitem(sys.modules, 'rapidfuzz', None)
    monkeypatch.setitem(sys.modules, 'rapidfuzz.distance', None)
    calls = []
    lev = native.lev_distance
    monkeypatch.setattr(native, 'lev_distance',
                        lambda a, b: calls.append((a, b)) or lev(a, b))
    for a, b in _random_pairs(7, 20):
        got = alignment.Alignment.get_levenshtein_distance(a, b)
        assert got == jax_alignment.Alignment.get_levenshtein_distance(a, b)
        assert got[0] == alignment._levenshtein(a, b)
    assert len(calls) == 20
