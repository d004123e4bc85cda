"""Model-resource registry and resolver.

A copy of the JAX package's ``wrapper/resources.py`` (host code), kept here so
the port imports nothing of that package.

The reference registers its downloadable pretrained models in
``wrapper/ocrd-tool.json`` (reference ocrd-tool.json:61-74) and resolves
``model_file`` parameters through the OCR-D resource manager, which
searches the per-processor data directories and downloads registered
names on demand (reference transcode.py:58 ``self.resolve_resource``).

This module is the standalone equivalent: the ``resources`` blocks in
our own ``ocrd-tool.json`` register each known model with a name, a
size, a description, and either

- ``url``   — a remote artifact, fetched on first use into the first
  writable data directory (honest-failure on closed networks), or
- ``path``  — a repo-relative bundled artifact (the synthetic
  testmodels), resolved against the package checkout.

Resolution order for a ``model_file`` value:

1. an existing absolute or CWD/data-dir-relative path wins unchanged,
2. a registered name is searched for in the data directories
   (``$CORASVANN_DATA``, ``~/.local/share/cor-asv-ann``,
   ``~/.local/share/ocrd-resources/<executable>``),
3. a registered ``path`` resource is resolved against the repo root,
4. a registered ``url`` resource is downloaded (unless
   ``CORASVANN_NO_DOWNLOAD=1``), with a size check against the
   registered byte count.
"""

import json
import os
import urllib.error
import urllib.request

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_HERE))

DEFAULT_EXECUTABLE = 'ocrd-cor-asv-ann-process'


def load_tool_json():
    """Parse the packaged ocrd-tool.json."""
    with open(os.path.join(_HERE, 'ocrd-tool.json'), encoding='utf-8') as f:
        return json.load(f)


def list_resources(executable=DEFAULT_EXECUTABLE):
    """All registered resource records for one processor."""
    tool = load_tool_json()['tools'].get(executable, {})
    return list(tool.get('resources', []))


def find_resource(name, executable=DEFAULT_EXECUTABLE):
    """Registry record for ``name``, or None if unregistered."""
    for res in list_resources(executable):
        if res.get('name') == name:
            return res
    return None


def data_dirs(executable=DEFAULT_EXECUTABLE):
    """Search/download directories, most specific first."""
    dirs = []
    env = os.environ.get('CORASVANN_DATA')
    if env:
        dirs.append(env)
    dirs.append(os.path.expanduser('~/.local/share/cor-asv-ann'))
    dirs.append(os.path.expanduser(
        '~/.local/share/ocrd-resources/' + executable))
    return dirs


def _verify_size(path, res):
    """Warn (don't fail) when a resolved artifact's size disagrees with
    its registration — a truncated download is the common cause."""
    want = res.get('size')
    if not want:
        return
    have = os.path.getsize(path)
    if have != want:
        import logging
        logging.getLogger('cor_asv_ann_tpu_torch.resources').warning(
            'resource %s at %s is %d bytes, registry says %d '
            '(truncated download?)', res['name'], path, have, want)


def download_resource(res, dest_dir=None, executable=DEFAULT_EXECUTABLE):
    """Fetch a ``url`` resource into a data directory and return its path.

    Raises OSError subclasses on network failure; partial files are
    removed so a retry starts clean.
    """
    url = res.get('url')
    if not url:
        raise ValueError('resource %r has no url' % res.get('name'))
    if dest_dir is None:
        for cand in data_dirs(executable):
            try:
                os.makedirs(cand, exist_ok=True)
                dest_dir = cand
                break
            except OSError:
                continue
        else:
            raise OSError('no writable data directory for download')
    dest = os.path.join(dest_dir, res['name'])
    tmp = dest + '.part'
    try:
        with urllib.request.urlopen(url, timeout=60) as src, \
                open(tmp, 'wb') as out:
            while True:
                chunk = src.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _verify_size(dest, res)
    return dest


def resolve_resource(name, executable=DEFAULT_EXECUTABLE):
    """Resolve a model file name or registered resource name to a path.

    See module docstring for the search order. Raises FileNotFoundError
    with the registered names when nothing matches.
    """
    # 1. plain paths: absolute, CWD-relative, data-dir-relative
    if os.path.isabs(name):
        if os.path.exists(name):
            return name
    else:
        for base in [''] + data_dirs(executable):
            cand = os.path.join(base, name) if base else name
            if os.path.exists(cand):
                res = find_resource(name, executable)
                if res:
                    _verify_size(cand, res)
                return cand

    # 2. registered names
    res = find_resource(name, executable)
    if res is not None:
        if res.get('path'):
            bundled = os.path.join(_REPO_ROOT, res['path'])
            if os.path.exists(bundled):
                _verify_size(bundled, res)
                return bundled
        if res.get('url') and \
                os.environ.get('CORASVANN_NO_DOWNLOAD', '') != '1':
            try:
                return download_resource(res, executable=executable)
            except (urllib.error.URLError, OSError, ValueError) as exc:
                raise FileNotFoundError(
                    'registered resource %r could not be downloaded from '
                    '%s (%s); fetch it manually into one of %s' %
                    (name, res['url'], exc, data_dirs(executable)))

    registered = [r.get('name') for r in list_resources(executable)]
    raise FileNotFoundError(
        'cannot resolve model resource %r: not a file under CWD or %s, '
        'and not a registered name (registered: %s; set CORASVANN_DATA '
        'to add a search directory)' %
        (name, data_dirs(executable), registered))
