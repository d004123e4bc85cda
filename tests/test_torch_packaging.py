"""PyTorch port: ``pyproject.toml`` installs all of the port.

An installed copy holds only the packages that ``[tool.setuptools]
packages`` names and the data files that ``package-data`` matches, while
the tests run from the source tree and would not notice a missing one.
So every directory of ``cor_asv_ann_tpu_torch/`` that holds an
``__init__.py`` must be listed, and every file that is not Python and
not a build product (the kernels' ``csrc/*.cu`` and ``csrc/*.cuh``, the
``native/`` sources of the edit-distance library, ``ocrd-tool.json``)
must be matched. The files are those git tracks where the tree is a git
checkout (so an untracked editor or build file is no case), else those on
disk. Reads the file with ``tomllib``; installs nothing and imports
neither package.
"""

import fnmatch
import os
import subprocess
import tomllib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = 'cor_asv_ann_tpu_torch'
# what the port builds at first use, beside its sources
BUILD_PRODUCTS = ('*.so', '*.o', '*.pyc')


def _setuptools():
    with open(os.path.join(ROOT, 'pyproject.toml'), 'rb') as f:
        return tomllib.load(f)['tool']['setuptools']


def _tracked():
    """The port's files that git tracks, relative to ROOT; [] where ROOT
    is no git checkout (an unpacked archive) or git is missing."""
    try:
        run = subprocess.run(['git', 'ls-files', '-z', '--', PORT],
                             cwd=ROOT, capture_output=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return []
    return [p for p in run.stdout.decode().split('\0')
            if p and os.path.isfile(os.path.join(ROOT, p))]


def _walk():
    """(directory, sorted file names) of the port, relative to ROOT."""
    tracked = _tracked()
    if tracked:
        dirs = {}
        for p in tracked:
            dirs.setdefault(os.path.dirname(p), []).append(
                os.path.basename(p))
        for path in sorted(dirs):
            yield path.replace('/', os.sep), sorted(dirs[path])
        return
    for path, dirs, files in os.walk(os.path.join(ROOT, PORT)):
        dirs[:] = sorted(d for d in dirs if d != '__pycache__')
        yield os.path.relpath(path, ROOT), sorted(files)


PACKAGES = [path.replace(os.sep, '.') for path, files in _walk()
            if '__init__.py' in files]
DATA_FILES = [os.path.join(path, name) for path, files in _walk()
              for name in files
              if not name.endswith('.py')
              and not any(fnmatch.fnmatch(name, p) for p in BUILD_PRODUCTS)]


def test_the_port_has_its_packages_and_sources():
    assert {PORT, PORT + '.ops', PORT + '.parallel'} <= set(PACKAGES)
    for src in ('csrc/decode_step.cu', 'csrc/step_tile.cuh',
                'native/editops.cpp', 'native/Makefile'):
        assert os.path.join(PORT, src) in DATA_FILES


@pytest.mark.parametrize('package', PACKAGES)
def test_package_is_listed(package):
    assert package in _setuptools()['packages']


def _installed(path, setuptools):
    """Whether a package-data pattern of a listed package matches the
    file (the patterns are relative to the package's directory)."""
    data = setuptools.get('package-data', {})
    for package in setuptools['packages']:
        prefix = package.replace('.', os.sep) + os.sep
        if not path.startswith(prefix):
            continue
        rel = path[len(prefix):]
        if any(fnmatch.fnmatch(rel, pattern)
               for pattern in data.get(package, []) + data.get('*', [])):
            return True
    return False


@pytest.mark.parametrize('path', DATA_FILES)
def test_data_file_is_installed(path):
    assert _installed(path, _setuptools()), path
