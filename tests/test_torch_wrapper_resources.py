"""PyTorch port: the model-resource registry and resolver.

Counterparts of tests/test_resources.py for the port's copy of
``wrapper/resources.py``: the registry in the port's ocrd-tool.json,
name resolution through data dirs and the repo's bundled models (the
port's package resolves them from its own location), the download path
driven through local file:// URLs only, and honest failure. The
registry and every resolution equal the JAX package's.
"""

import json
import os
import urllib.error

import pytest

from cor_asv_ann_tpu.wrapper import resources as JR
from cor_asv_ann_tpu_torch.wrapper import resources as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_registry_well_formed():
    """Every record has a name, a size, and exactly one of url/path;
    path-backed (bundled) records exist on disk at the pinned size."""
    recs = R.list_resources()
    assert recs == JR.list_resources()
    assert len(recs) >= 4
    names = [r['name'] for r in recs]
    assert len(set(names)) == len(names)
    for rec in recs:
        assert rec['name'] and isinstance(rec['size'], int)
        assert rec.get('description')
        assert bool(rec.get('url')) != bool(rec.get('path'))
        if rec.get('path'):
            full = os.path.join(REPO, rec['path'])
            assert os.path.exists(full), full
            assert os.path.getsize(full) == rec['size']


def test_reference_published_models_registered():
    """The reference's two published pretrained models are registered
    with their exact byte sizes (reference ocrd-tool.json:66,72)."""
    conf = R.find_resource(
        's2s.dta19.Fraktur4.d2.w0512.adam.attention.stateless.'
        'variational-dropout.char.pretrained+retrained-conf.h5')
    assert conf and conf['size'] == 53735168 and conf['url']
    lm = R.find_resource(
        's2s.gt4histocr.s-ſ.d2.w0512.adam.attention.stateless.'
        'variational-dropout.char.transfer-lm.h5')
    assert lm and lm['size'] == 53552788 and lm['url']


def test_resolve_bundled_by_registered_name():
    out = R.resolve_resource('flagship.d2.w512.synthetic.h5')
    assert out == JR.resolve_resource('flagship.d2.w512.synthetic.h5')
    assert os.path.samefile(out, os.path.join(
        REPO, 'testmodels/flagship.d2.w512.synthetic.h5'))


def test_resolve_prefers_data_dir_over_bundled(tmp_path, monkeypatch):
    """A user-installed copy in $CORASVANN_DATA wins over the bundled
    path (lets users swap in retrained weights under the same name)."""
    local = tmp_path / 'soak.d2.w128.synthetic.h5'
    local.write_bytes(b'not a real model')
    monkeypatch.setenv('CORASVANN_DATA', str(tmp_path))
    out = R.resolve_resource('soak.d2.w128.synthetic.h5')
    assert os.path.samefile(out, local)


def test_resolve_plain_paths_still_work(tmp_path, monkeypatch):
    f = tmp_path / 'mymodel.h5'
    f.write_bytes(b'x')
    assert R.resolve_resource(str(f)) == str(f)
    monkeypatch.chdir(tmp_path)
    assert os.path.samefile(R.resolve_resource('mymodel.h5'), f)


def test_resolve_unknown_name_lists_registry(tmp_path, monkeypatch):
    monkeypatch.setenv('CORASVANN_DATA', str(tmp_path))
    with pytest.raises(FileNotFoundError) as exc:
        R.resolve_resource('no-such-model.h5')
    msg = str(exc.value)
    assert 'registered' in msg and 'flagship.d2.w512.synthetic.h5' in msg


def test_download_url_resource(tmp_path, monkeypatch):
    """A url-backed registered name is fetched into the first writable
    data dir on resolution (file:// stands in for https here)."""
    src = tmp_path / 'remote.h5'
    src.write_bytes(b'model bytes' * 100)
    rec = {'name': 'dl-test.h5', 'url': src.as_uri(),
           'size': src.stat().st_size, 'description': 't'}
    data = tmp_path / 'data'
    monkeypatch.setenv('CORASVANN_DATA', str(data))
    monkeypatch.setattr(R, 'list_resources', lambda *a, **k: [rec])
    out = R.resolve_resource('dl-test.h5')
    assert out == str(data / 'dl-test.h5')
    assert open(out, 'rb').read() == src.read_bytes()
    # second resolution hits the downloaded copy, no re-fetch
    src.unlink()
    assert R.resolve_resource('dl-test.h5') == out


def test_download_size_mismatch_warns(tmp_path, monkeypatch, caplog):
    src = tmp_path / 'remote.h5'
    src.write_bytes(b'short')
    rec = {'name': 'dl-short.h5', 'url': src.as_uri(),
           'size': 999999, 'description': 't'}
    monkeypatch.setenv('CORASVANN_DATA', str(tmp_path / 'data'))
    with caplog.at_level('WARNING', 'cor_asv_ann_tpu_torch.resources'):
        out = R.download_resource(rec)
    assert os.path.exists(out)
    assert any('truncated' in r.message for r in caplog.records)


def test_download_failure_is_honest(tmp_path, monkeypatch):
    """Closed network => FileNotFoundError telling the user what to
    fetch and where to put it; no .part litter left behind."""
    rec = {'name': 'dl-fail.h5', 'url': 'file:///nonexistent/x.h5',
           'size': 1, 'description': 't'}
    data = tmp_path / 'data'
    monkeypatch.setenv('CORASVANN_DATA', str(data))
    monkeypatch.setattr(R, 'list_resources', lambda *a, **k: [rec])
    with pytest.raises(FileNotFoundError) as exc:
        R.resolve_resource('dl-fail.h5')
    assert 'could not be downloaded' in str(exc.value)
    assert not list(data.glob('*.part'))


def test_no_download_env_gate(tmp_path, monkeypatch):
    rec = {'name': 'dl-gated.h5', 'url': 'file:///nonexistent/x.h5',
           'size': 1, 'description': 't'}
    monkeypatch.setenv('CORASVANN_DATA', str(tmp_path))
    monkeypatch.setenv('CORASVANN_NO_DOWNLOAD', '1')
    monkeypatch.setattr(R, 'list_resources', lambda *a, **k: [rec])
    with pytest.raises(FileNotFoundError) as exc:
        R.resolve_resource('dl-gated.h5')
    # gated: reported as unresolved, not as a failed download
    assert 'could not be downloaded' not in str(exc.value)


def test_transcode_uses_registry():
    """The processor's resolver IS the registry resolver (transcode.py
    imports it), so `-P model_file <registered-name>` works."""
    from cor_asv_ann_tpu_torch.wrapper.transcode import resolve_resource
    out = resolve_resource('flagship.d2.w512.synthetic.h5')
    assert out.endswith('testmodels/flagship.d2.w512.synthetic.h5')
