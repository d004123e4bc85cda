"""PyTorch port: METS server, page-parallel processing, processor server
and worker modes.

Counterparts of tests/test_server_modes.py for the port's copies of
``utils/mets_server.py``, ``wrapper/base.py`` and ``wrapper/server.py``:
the same runtime-config matrix (plain, page-parallel, METS server, both)
and server/worker protocol, and where a run writes pages, the port's
bytes are held equal to the JAX package's direct run on the same input.
"""

import json
import http.client
import threading

import pytest

from cor_asv_ann_tpu.utils import workspace as jax_workspace
from cor_asv_ann_tpu.wrapper import join as jax_join
from cor_asv_ann_tpu.wrapper import mark as jax_mark
from cor_asv_ann_tpu_torch.utils import page as P
from cor_asv_ann_tpu_torch.utils.mets_server import (
    MetsClientWorkspace, MetsServer)
from cor_asv_ann_tpu_torch.utils.workspace import Workspace, make_workspace
from cor_asv_ann_tpu_torch.wrapper.evaluate import EvaluateLines
from cor_asv_ann_tpu_torch.wrapper.join import JoinLines
from cor_asv_ann_tpu_torch.wrapper.mark import MarkWords
from cor_asv_ann_tpu_torch.wrapper.server import (
    ProcessorServer, client_process, run_worker)

PAGES = ['p%d' % i for i in range(1, 5)]
TEXTS = {
    'p1': ['Der Hvnd liegt', 'im Garten'],
    'p2': ['Die Katzc sitzt'],
    'p3': ['Der Hund liegt', 'Die Katze'],
    'p4': ['im Garten sitzt', 'Der Hvnd'],
}


def make_doc(line_texts, conf=0.9):
    doc = P.new_page()
    region = P.add_region(doc, 'r1')
    for i, text in enumerate(line_texts):
        line = P.add_line(region, 'l%d' % (i + 1),
                          points=[(0, i * 20), (100, i * 20 + 18)])
        x = 0
        for j, wtext in enumerate(text.split(' ')):
            w = P.add_word(line, 'l%d_w%d' % (i + 1, j + 1),
                           points=[(x, i * 20),
                                   (x + 10 * len(wtext), i * 20 + 18)])
            w.add_textequiv(wtext, conf=conf)
            x += 10 * len(wtext) + 5
        line.add_textequiv(text, conf=conf)
    return doc


def build_ws(root, grps=('OCR',)):
    ws = make_workspace(str(root), PAGES)
    for grp in grps:
        for pid in PAGES:
            ws.add_file(grp, pid, make_doc(TEXTS[pid]).to_bytes())
    ws.save()
    return ws


def spell_script(tmp_path):
    """Fake hunspell -w -L: echo words NOT in the dictionary."""
    script = tmp_path / 'spell.sh'
    script.write_text(
        '#!/bin/sh\nwhile read w; do\n'
        'case "$w" in Der|Die|Hund|Katze|im|Garten|liegt|sitzt) ;; '
        '*) echo "$w";; esac\ndone\n')
    script.chmod(0o755)
    return str(script)


def grp_bytes(directory, grp):
    ws = Workspace(str(directory))
    return {pid: open(f.path, 'rb').read()
            for pid, f in ws.page_files(grp).items()}


def jax_grp_bytes(root, cls, params, input_grps, output_grp,
                  grps=('OCR',)):
    """The JAX package's processor `cls`, run directly on the same input
    pages in a workspace of its own: {page id: output bytes}."""
    ws = jax_workspace.make_workspace(str(root), PAGES)
    for grp in grps:
        for pid in PAGES:
            ws.add_file(grp, pid, make_doc(TEXTS[pid]).to_bytes())
    ws.save()
    cls(parameter=params).process_workspace(str(root), input_grps,
                                            output_grp)
    ws = jax_workspace.Workspace(str(root))
    return {pid: open(f.path, 'rb').read()
            for pid, f in ws.page_files(output_grp).items()}


# -- METS server ------------------------------------------------------

def test_mets_server_roundtrip(tmp_path):
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    sock = str(tmp_path / 'mets.sock')
    server = MetsServer(str(ws_dir), sock).start()
    try:
        client = MetsClientWorkspace(sock, directory=str(ws_dir))
        assert client.page_ids() == PAGES
        assert 'OCR' in client.file_groups()
        direct = Workspace(str(ws_dir))
        got = client.page_files('OCR')
        want = direct.page_files('OCR')
        assert set(got) == set(want)
        assert all(got[p].path == want[p].path for p in got)
        # write through the server, then check the on-disk METS
        client.add_file('OUT', 'p1', make_doc(['neu']).to_bytes())
        client.save()
        reread = Workspace(str(ws_dir))
        assert 'p1' in reread.page_files('OUT')
        text = P.parse_page(reread.page_files('OUT')['p1'].path) \
            .get_lines()[0].get_text()
        assert text == 'neu'
    finally:
        server.stop()


def test_mets_server_tcp_and_errors(tmp_path):
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    server = MetsServer(str(ws_dir), '127.0.0.1:0')
    # the ephemeral port is known only after bind
    addr = '127.0.0.1:%d' % server._server.server_address[1]
    server.start()
    try:
        client = MetsClientWorkspace(addr, directory=str(ws_dir))
        assert client.page_ids() == PAGES
        with pytest.raises(RuntimeError, match='unknown method'):
            client._call('bogus')
    finally:
        server.stop()


# -- page-parallel + runtime-config matrix ----------------------------

@pytest.mark.parametrize('config', [
    '', 'pageparallel', 'metsserver', 'pageparallel+metsserver'])
def test_mark_runtime_configs(tmp_path, monkeypatch, config):
    """All four runtime configs must produce byte-identical outputs
    (the reference asserts identical CERs across its configs,
    test_all.py:267-271; the standalone layer can hold the stronger
    byte bar)."""
    ws_dir = tmp_path / ('ws_' + (config.replace('+', '_') or 'plain'))
    build_ws(ws_dir)
    script = spell_script(tmp_path)
    if 'pageparallel' in config:
        monkeypatch.setenv('OCRD_MAX_PARALLEL_PAGES', '4')
    else:
        monkeypatch.delenv('OCRD_MAX_PARALLEL_PAGES', raising=False)
    proc = MarkWords(parameter={'command': script, 'format': 'OOV'})
    if 'metsserver' in config:
        sock = str(tmp_path / 'mets.sock')
        server = MetsServer(str(ws_dir), sock).start()
        try:
            proc.process_workspace(
                MetsClientWorkspace(sock, directory=str(ws_dir)),
                ['OCR'], 'MARK')
        finally:
            server.stop()
    else:
        proc.process_workspace(str(ws_dir), ['OCR'], 'MARK')
    # marks: exactly the two Hvnd + one Katzc tokens across 4 pages
    assert proc.total_nonmatches == 3
    assert proc.total_candidates == sum(
        len(t.split()) for ts in TEXTS.values() for t in ts)
    got = grp_bytes(ws_dir, 'MARK')
    # build the serial baseline once and compare bytes
    base_dir = tmp_path / 'ws_baseline'
    build_ws(base_dir)
    monkeypatch.delenv('OCRD_MAX_PARALLEL_PAGES', raising=False)
    MarkWords(parameter={'command': script, 'format': 'OOV'}) \
        .process_workspace(str(base_dir), ['OCR'], 'MARK')
    assert got == grp_bytes(base_dir, 'MARK')
    assert got == jax_grp_bytes(tmp_path / 'ws_jax', jax_mark.MarkWords,
                                {'command': script, 'format': 'OOV'},
                                ['OCR'], 'MARK')


def test_pageparallel_partial_registration(tmp_path, monkeypatch):
    """A failing page must not discard earlier pages' outputs: the
    parallel pool registers results incrementally in page order, so
    pages before the failure are in the output fileGrp (exactly like
    the serial path), pages at/after it are not."""
    from cor_asv_ann_tpu_torch.wrapper.base import PageProcessor

    class Flaky(PageProcessor):
        executable = 'test-flaky'

        def process_page(self, docs, page_id):
            if page_id == 'p3':
                raise RuntimeError('boom on p3')
            return docs[0]

    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    monkeypatch.setenv('OCRD_MAX_PARALLEL_PAGES', '4')
    ws = Workspace(str(ws_dir))
    with pytest.raises(RuntimeError, match='boom on p3'):
        Flaky(parameter={}).process_workspace(ws, ['OCR'], 'OUT')
    registered = set(ws.page_files('OUT'))
    assert registered == {'p1', 'p2'}


def test_mets_client_dead_server(tmp_path, monkeypatch):
    """A METS server that dies mid-request (closes without replying) or
    hangs must surface a clear RuntimeError instead of a bare
    JSONDecodeError / an indefinite block."""
    import socket
    import time
    from cor_asv_ann_tpu_torch.utils import mets_server as M

    sock_path = str(tmp_path / 'dead.sock')
    srv = socket.socket(socket.AF_UNIX)
    srv.bind(sock_path)
    srv.listen(2)

    def accept_and_close():
        conn, _ = srv.accept()
        conn.close()

    threading.Thread(target=accept_and_close, daemon=True).start()
    client = MetsClientWorkspace(sock_path)
    with pytest.raises(RuntimeError, match='without replying'):
        client.page_ids()

    def accept_and_hang():
        conn, _ = srv.accept()
        time.sleep(10)
        conn.close()

    threading.Thread(target=accept_and_hang, daemon=True).start()
    monkeypatch.setattr(M, 'CALL_TIMEOUT', 0.3)
    with pytest.raises(RuntimeError, match='did not answer'):
        client.page_ids()
    srv.close()


def test_parallel_caps(monkeypatch):
    monkeypatch.setenv('OCRD_MAX_PARALLEL_PAGES', '4')
    assert EvaluateLines(parameter={})._parallel_pages(8) == 1
    assert JoinLines(parameter={})._parallel_pages(8) == 4
    monkeypatch.setenv('OCRD_MAX_PARALLEL_PAGES', 'junk')
    assert JoinLines(parameter={})._parallel_pages(8) == 1
    monkeypatch.delenv('OCRD_MAX_PARALLEL_PAGES')
    assert JoinLines(parameter={})._parallel_pages(8) == 1


# -- processor server -------------------------------------------------

def test_processor_server(tmp_path):
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir, grps=('OCR', 'OCR2'))
    server = ProcessorServer(JoinLines, '127.0.0.1:0').start()
    try:
        host, port = server.address.rsplit(':', 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        conn.request('GET', '/info')
        info = json.loads(conn.getresponse().read())
        assert info['executable'] == 'ocrd-cor-asv-ann-join'
        assert 'match-on' in info['parameters']
        conn.close()
        job = {'workspace': str(ws_dir),
               'input_file_grp': 'OCR,OCR2',
               'output_file_grp': 'JOIN',
               'parameter': {'add-filegrp-index': True}}
        result = client_process(server.address, job)
        assert result['ok']
        assert grp_bytes(ws_dir, 'JOIN') == jax_grp_bytes(
            tmp_path / 'ws_jax', jax_join.JoinLines,
            {'add-filegrp-index': True}, ['OCR', 'OCR2'], 'JOIN',
            grps=('OCR', 'OCR2'))
        ws = Workspace(str(ws_dir))
        doc = P.parse_page(ws.page_files('JOIN')['p1'].path)
        tes = doc.get_lines()[0].get_textequivs()
        assert [te.index for te in tes] == [0, 1]
        # second job on the same parameters reuses the cached processor
        job2 = dict(job, output_file_grp='JOIN2', page_id='p2')
        assert client_process(server.address, job2)['ok']
        assert len(server._cache) == 1
        assert 'p2' in Workspace(str(ws_dir)).page_files('JOIN2')
        # bad jobs are reported, not fatal
        with pytest.raises(RuntimeError, match='processor server'):
            client_process(server.address, {'workspace': str(ws_dir),
                                            'input_file_grp': 'OCR'})
    finally:
        server.stop()


def test_processor_server_with_mets_server(tmp_path):
    """Server mode + METS server combined (the reference's full
    worker/server deployment shape)."""
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir, grps=('OCR', 'OCR2'))
    sock = str(tmp_path / 'mets.sock')
    mets = MetsServer(str(ws_dir), sock).start()
    server = ProcessorServer(JoinLines, '127.0.0.1:0').start()
    try:
        result = client_process(server.address, {
            'workspace': str(ws_dir), 'mets_server_url': sock,
            'input_file_grp': 'OCR,OCR2', 'output_file_grp': 'JOIN'})
        assert result['ok']
        assert set(Workspace(str(ws_dir)).page_files('JOIN')) == set(PAGES)
    finally:
        server.stop()
        mets.stop()


# -- worker (directory queue) -----------------------------------------

def test_worker_queue(tmp_path):
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    queue = tmp_path / 'queue'
    queue.mkdir()
    script = spell_script(tmp_path)
    job = {'workspace': str(ws_dir), 'input_file_grp': 'OCR',
           'output_file_grp': 'MARK',
           'parameter': {'command': script, 'format': 'OOV'}}
    (queue / 'job1.json').write_text(json.dumps(job))
    run_worker(MarkWords, str(queue), once=True, timeout=10)
    result = json.loads((queue / 'job1.json.result.json').read_text())
    assert result['ok']
    assert set(Workspace(str(ws_dir)).page_files('MARK')) == set(PAGES)
    assert grp_bytes(ws_dir, 'MARK') == jax_grp_bytes(
        tmp_path / 'ws_jax', jax_mark.MarkWords,
        {'command': script, 'format': 'OOV'}, ['OCR'], 'MARK')
    # queue is drained
    assert not (queue / 'job1.json').exists()
    assert not (queue / 'job1.json.claimed').exists()
    # failing job reports the error in its result file
    (queue / 'job2.json').write_text(json.dumps(
        dict(job, input_file_grp='NOSUCH', output_file_grp='X')))
    run_worker(MarkWords, str(queue), once=True, timeout=10)
    result2 = json.loads((queue / 'job2.json.result.json').read_text())
    assert not result2['ok']
    assert 'error' in result2


# -- CLI surface ------------------------------------------------------

def test_cli_subcommands():
    from click.testing import CliRunner
    from cor_asv_ann_tpu_torch.wrapper.join import ocrd_cor_asv_ann_join as cli
    runner = CliRunner()
    out = runner.invoke(cli, ['--help'])
    assert out.exit_code == 0
    assert 'server' in out.output and 'worker' in out.output
    assert '--mets-server-url' in out.output
    # direct mode without -I is a usage error
    out = runner.invoke(cli, [])
    assert out.exit_code != 0
    assert 'input-file-grp' in out.output
    out = runner.invoke(cli, ['server', '--help'])
    assert out.exit_code == 0 and '--address' in out.output
    out = runner.invoke(cli, ['worker', '--help'])
    assert out.exit_code == 0 and '--queue' in out.output


def test_cli_with_mets_server(tmp_path):
    """Full CLI run against a METS server via -U."""
    from click.testing import CliRunner
    from cor_asv_ann_tpu_torch.wrapper.mark import ocrd_cor_asv_ann_mark as cli
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    sock = str(tmp_path / 'mets.sock')
    server = MetsServer(str(ws_dir), sock).start()
    try:
        out = CliRunner().invoke(cli, [
            '-m', str(ws_dir), '-I', 'OCR', '-O', 'MARK',
            '-U', sock,
            '-P', 'command', spell_script(tmp_path),
            '-P', 'format', 'OOV'])
        assert out.exit_code == 0, out.output
        assert set(Workspace(str(ws_dir)).page_files('MARK')) == set(PAGES)
    finally:
        server.stop()


def test_align_pageparallel_deterministic(tmp_path, monkeypatch):
    """AlignLines is page-parallel safe: the per-page aligner state must
    not be shared across worker threads."""
    from cor_asv_ann_tpu_torch.wrapper.align import AlignLines

    def run(root, parallel):
        ws = make_workspace(str(root), PAGES)
        variants = {'OCR1': 0, 'OCR2': 1, 'OCR3': 2}
        for grp, shift in variants.items():
            for pid in PAGES:
                texts = [t.replace('e', 'c') if shift == 1 else
                         (t.replace('n', 'u') if shift == 2 else t)
                         for t in TEXTS[pid]]
                ws.add_file(grp, pid, make_doc(texts).to_bytes())
        ws.save()
        if parallel:
            monkeypatch.setenv('OCRD_MAX_PARALLEL_PAGES', '4')
        else:
            monkeypatch.delenv('OCRD_MAX_PARALLEL_PAGES', raising=False)
        AlignLines(parameter={'method': 'majority'}).process_workspace(
            str(root), ['OCR1', 'OCR2', 'OCR3'], 'MAJ')
        return grp_bytes(root, 'MAJ')

    serial = run(tmp_path / 'serial', False)
    parallel = run(tmp_path / 'parallel', True)
    assert serial == parallel


def test_worker_idle_timeout_zero(tmp_path):
    """timeout=0 exits immediately on an empty queue (0 is a real
    timeout, not 'no timeout')."""
    import time as _time
    queue = tmp_path / 'queue'
    queue.mkdir()
    t0 = _time.time()
    run_worker(MarkWords, str(queue), timeout=0)
    assert _time.time() - t0 < 5


def test_execute_job_cache_lru(tmp_path):
    from cor_asv_ann_tpu_torch.wrapper.server import CACHE_SIZE, execute_job
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    script = spell_script(tmp_path)
    cache = {}
    for i in range(CACHE_SIZE + 2):
        job = {'workspace': str(ws_dir), 'input_file_grp': 'OCR',
               'output_file_grp': 'M%d' % i,
               'parameter': {'command': '%s # v%d' % (script, i),
                             'format': 'OOV'}}
        execute_job(MarkWords, job, cache=cache)
    assert len(cache) == CACHE_SIZE
    # the oldest parameter sets were evicted, the newest retained
    kept = [json.loads(k)['command'] for k in cache]
    assert all(int(c.rsplit('v', 1)[1]) >= 2 for c in kept)


def test_bare_directory_page_ids_roundtrip(tmp_path):
    """Bare-PAGE-XML mode (no mets.xml): output files must be named by
    page id so chained processors see matching ids across fileGrps."""
    import os
    ws_dir = tmp_path / 'bare'
    os.makedirs(ws_dir / 'OCR')
    for pid in ('p1', 'p2'):
        (ws_dir / 'OCR' / ('%s.xml' % pid)).write_bytes(
            make_doc(TEXTS[pid]).to_bytes())
    ws = Workspace(str(ws_dir))
    assert sorted(ws.page_files('OCR')) == ['p1', 'p2']
    script = spell_script(tmp_path)
    MarkWords(parameter={'command': script}).process_workspace(
        ws, ['OCR'], 'MARK')
    reread = Workspace(str(ws_dir))
    assert sorted(reread.page_files('MARK')) == ['p1', 'p2']
    # a chained multi-fileGrp step finds matching pages
    join = JoinLines(parameter={'add-filegrp-index': True})
    join.process_workspace(reread, ['OCR', 'MARK'], 'JOIN')
    assert sorted(Workspace(str(ws_dir)).page_files('JOIN')) == ['p1', 'p2']


def test_worker_stale_claim_recovery(tmp_path, monkeypatch):
    """A job claimed by a worker that died must be released back into
    the queue after STALE_CLAIM_SECONDS instead of being lost."""
    import json as J
    import os
    import time
    from cor_asv_ann_tpu_torch.wrapper import server as S

    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    queue = tmp_path / 'q'
    os.makedirs(queue)
    job = {'workspace': str(ws_dir), 'input_file_grp': 'OCR',
           'output_file_grp': 'MARK',
           'parameter': {'command': spell_script(tmp_path)}}
    path = queue / 'job1.json'
    path.write_text(J.dumps(job))
    # simulate a dead worker's orphaned claim, older than the threshold
    os.rename(path, str(path) + '.claimed')
    old = time.time() - 10
    os.utime(str(path) + '.claimed', (old, old))
    monkeypatch.setattr(S, 'STALE_CLAIM_SECONDS', 5.0)
    run_worker(MarkWords, str(queue), once=True, timeout=5.0)
    result = J.loads((queue / 'job1.json.result.json').read_text())
    assert result.get('ok'), result


def test_index_page_files_skips_non_pages(tmp_path):
    from cor_asv_ann_tpu_torch.utils.workspace import (WorkspaceFile,
                                                 index_page_files)
    files = [
        WorkspaceFile('f1', 'OCR', 'p1', '/x/p1.xml', None),
        WorkspaceFile('f2', 'IMG', 'p1', '/x/p1.jpg', 'image/jpeg'),
        WorkspaceFile('f3', 'IMG', 'p2', None, 'image/jpeg'),
        WorkspaceFile('f4', 'OCR', 'p2', '/x/p2.page',
                      'application/vnd.prima.page+xml'),
        WorkspaceFile('f5', 'BIN', 'p3', '/x/p3.bin', None),
    ]
    out = index_page_files(files)
    assert sorted(out) == ['p1', 'p2']
    assert out['p1'].id == 'f1' and out['p2'].id == 'f4'


def test_execute_job_empty_page_id_means_all_pages(tmp_path):
    """'' (the conventional all-pages value in job payloads) must not
    be taken as the single nonexistent page '' (''.split(',')==[''])."""
    from cor_asv_ann_tpu_torch.wrapper.server import execute_job
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir, grps=('OCR', 'OCR2'))
    job = {'workspace': str(ws_dir), 'input_file_grp': 'OCR,OCR2',
           'output_file_grp': 'JOIN', 'page_id': ''}
    result = execute_job(JoinLines, job)
    assert result['ok']
    assert set(Workspace(str(ws_dir)).page_files('JOIN')) == set(PAGES)


def test_worker_releases_tagged_orphan_claims(tmp_path, monkeypatch):
    """Claims carry worker-unique suffixes (.claimed.<pid>.<tid>);
    a dead worker's tagged orphan must still be released and re-run."""
    import os
    import time
    from cor_asv_ann_tpu_torch.wrapper import server as S

    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    queue = tmp_path / 'q'
    os.makedirs(queue)
    job = {'workspace': str(ws_dir), 'input_file_grp': 'OCR',
           'output_file_grp': 'MARK',
           'parameter': {'command': spell_script(tmp_path)}}
    path = queue / 'job1.json'
    path.write_text(json.dumps(job))
    os.rename(path, str(path) + '.claimed.99999.1')
    old = time.time() - 10
    os.utime(str(path) + '.claimed.99999.1', (old, old))
    monkeypatch.setattr(S, 'STALE_CLAIM_SECONDS', 5.0)
    run_worker(MarkWords, str(queue), once=True, timeout=5.0)
    result = json.loads((queue / 'job1.json.result.json').read_text())
    assert result.get('ok'), result
    assert not (queue / 'job1.json.claimed.99999.1').exists()


def test_worker_fresh_claim_not_released(tmp_path, monkeypatch):
    """A claim's age counts from CLAIM time, not job creation time: a
    job that waited in the queue longer than STALE_CLAIM_SECONDS must
    not be released (= runnable twice) right after being claimed.  The
    claim epoch rides in the rename suffix itself, so claim creation
    and claim-age visibility are one atomic step (no utime window)."""
    import os
    import time
    from cor_asv_ann_tpu_torch.wrapper import server as S

    queue = tmp_path / 'q'
    os.makedirs(queue)
    path = queue / 'job1.json'
    path.write_text(json.dumps({'workspace': 'x', 'input_file_grp': 'Y'}))
    old = time.time() - 100
    os.utime(path, (old, old))      # job waited long in the queue
    monkeypatch.setattr(S, 'STALE_CLAIM_SECONDS', 50.0)

    claim_epochs = []
    real_rename = os.rename

    def rename_spy(src, dst, *args, **kwargs):
        if '.claimed.' in str(dst):
            # the instant the claim exists, its embedded epoch must
            # already be fresh — there is no separate freshen step a
            # concurrent stale scan could race against
            claim_epochs.append(float(str(dst).rsplit('.', 1)[1]))
        return real_rename(src, dst, *args, **kwargs)

    monkeypatch.setattr(S.os, 'rename', rename_spy)
    # the job itself fails fast (bogus workspace) — irrelevant here
    run_worker(MarkWords, str(queue), once=True, timeout=5.0)
    assert claim_epochs and time.time() - claim_epochs[0] < 50.0
    result = json.loads((queue / 'job1.json.result.json').read_text())
    assert 'ok' in result


def test_worker_stale_claim_with_result_is_dropped(tmp_path, monkeypatch):
    """An orphaned claim whose dead worker DID write the result file
    must be unlinked by the stale scan (not skipped forever)."""
    import os
    import time
    from cor_asv_ann_tpu_torch.wrapper import server as S

    queue = tmp_path / 'q'
    os.makedirs(queue)
    monkeypatch.setattr(S, 'STALE_CLAIM_SECONDS', 50.0)
    stale_epoch = int(time.time() - 100)
    claim = queue / ('job0.json.claimed.1.2.%d' % stale_epoch)
    claim.write_text(json.dumps({'workspace': 'x', 'input_file_grp': 'Y'}))
    (queue / 'job0.json.result.json').write_text('{"ok": true}')
    # idle scan (no live jobs): returns at the timeout
    run_worker(MarkWords, str(queue), once=True, timeout=0.5)
    assert not claim.exists()       # orphan cleaned up
    assert (queue / 'job0.json.result.json').exists()   # result kept


def test_mets_server_tcp_ephemeral_port(tmp_path):
    """host:0 binds an OS-assigned port; server.address must reflect
    the ACTUAL bound port so clients can connect."""
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    server = MetsServer(str(ws_dir), '127.0.0.1:0').start()
    try:
        assert server.address[1] != 0
        client = MetsClientWorkspace(server.address,
                                     directory=str(ws_dir))
        assert client.page_ids() == PAGES
    finally:
        server.stop()


def test_server_shutdown_waits_for_inflight_job(tmp_path):
    """POST /shutdown while a job is running must not kill the process
    mid-write: stop() drains the in-flight job before returning."""
    import time

    class SlowJoin(JoinLines):
        started = threading.Event()

        def process_page(self, docs, page_id):
            SlowJoin.started.set()
            time.sleep(0.3)
            return super().process_page(docs, page_id)

    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir, grps=('OCR', 'OCR2'))
    server = ProcessorServer(SlowJoin, '127.0.0.1:0').start()
    job = {'workspace': str(ws_dir), 'input_file_grp': 'OCR,OCR2',
           'output_file_grp': 'JOIN'}
    worker = threading.Thread(target=client_process,
                              args=(server.address, job))
    worker.start()
    try:
        assert SlowJoin.started.wait(timeout=10)
        server.stop()       # must block until the job committed
        assert set(Workspace(str(ws_dir)).page_files('JOIN')) == \
            set(PAGES)
    finally:
        worker.join(timeout=30)


def test_mets_server_runs_as_module(tmp_path):
    """``python -m cor_asv_ann_tpu_torch.utils.mets_server DIR -U SOCK``
    serves the workspace until a client stops it."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ws_dir = tmp_path / 'ws'
    build_ws(ws_dir)
    sock = str(tmp_path / 'mets.sock')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'cor_asv_ann_tpu_torch.utils.mets_server',
         str(ws_dir), '-U', sock],
        env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        assert 'listening on ' + sock in proc.stdout.readline()
        client = MetsClientWorkspace(sock, directory=str(ws_dir))
        assert client.page_ids() == PAGES
        client.stop_server()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
