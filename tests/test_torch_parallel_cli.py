"""PyTorch port: the command lines' --mesh under torchrun, on the CPU.

``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
cor_asv_ann_tpu_torch.scripts.train --device cpu --mesh 2 ...`` trains a
tiny model over a mesh of two ranks (gloo), then ``proc --mesh 2``
corrects a file with it: rank 0 alone writes, and what it writes equals
the output of ``proc`` without a mesh on the same model.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [("abba dig.", "abba dig."), ("chef gad.", "chef gad."),
         ("hi fi.", "hi fi."), ("dig dag.", "dig dag.")] * 8


def _env():
    env = dict(os.environ, CORASVANN_TEST_EPOCHS='1', OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (ROOT, os.environ.get('PYTHONPATH')) if p)
    return env


def _run(args, cwd, ranks=None, check=True):
    cmd = [sys.executable, '-m']
    if ranks:
        cmd += ['torch.distributed.run', '--standalone',
                '--nproc-per-node', str(ranks), '-m']
    proc = subprocess.run(cmd + args, cwd=cwd, env=_env(), text=True,
                          capture_output=True, timeout=300)
    if check and proc.returncode:
        raise AssertionError('%s failed (%d):\n%s' % (
            ' '.join(args), proc.returncode, proc.stderr[-4000:]))
    return proc


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """A model trained by `train --mesh 2` under torchrun."""
    tmp = tmp_path_factory.mktemp('mesh_cli')
    data = tmp / 'train.tsv'
    data.write_text(''.join('%s\t%s\n' % p for p in PAIRS))
    before = set(os.listdir(tmp))
    _run(['cor_asv_ann_tpu_torch.scripts.train', '--device', 'cpu',
          '--mesh', '2', '-m', str(tmp / 'model.h5'), '-w', '8', '-d', '2',
          str(data)], tmp, ranks=2)
    return tmp, sorted(set(os.listdir(tmp)) - before)


def test_torchrun_train_then_proc_over_mesh(trained, tmp_path):
    tmp, written = trained
    # rank 0 wrote the model and one epoch's checkpoint and state
    assert 'model.h5' in written and 'train_state.pkl' in written
    assert sum(name.startswith('model.ckpt.weights-01-')
               for name in written) == 1
    model = str(tmp / 'model.h5')
    text = tmp_path / 'in.txt'
    text.write_text('abba dig.\nchef gad.\nhi fi\ndig dag.\nabba\n')
    _run(['cor_asv_ann_tpu_torch.scripts.proc', '--device', 'cpu', '-f',
          '-m', model, str(text)], tmp_path)
    want = (tmp_path / 'in.cor.txt').read_text()
    os.remove(tmp_path / 'in.cor.txt')
    _run(['cor_asv_ann_tpu_torch.scripts.proc', '--device', 'cpu', '-f',
          '--mesh', '2', '-m', model, str(text)], tmp_path, ranks=2)
    assert sorted(os.listdir(tmp_path)) == ['in.cor.txt', 'in.txt']
    assert (tmp_path / 'in.cor.txt').read_text() == want
    assert len(want.splitlines()) == 5


def test_torchrun_mesh_must_be_the_world(trained, tmp_path):
    """--mesh 3 on a world of 2 ranks raises, naming both numbers."""
    tmp, _ = trained
    text = tmp_path / 'in.txt'
    text.write_text('abba dig.\n')
    proc = _run(['cor_asv_ann_tpu_torch.scripts.proc', '--device', 'cpu',
                 '-f', '--mesh', '3', '-m', str(tmp / 'model.h5'),
                 str(text)], tmp_path, ranks=2, check=False)
    assert proc.returncode != 0
    assert ('ValueError: requested 3 mesh devices but 2 are available'
            in proc.stderr)
    assert not (tmp_path / 'in.cor.txt').exists()
