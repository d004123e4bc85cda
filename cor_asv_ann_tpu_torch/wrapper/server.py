"""Standalone processor server and worker modes.

A copy of the JAX package's ``wrapper/server.py`` (host code), kept here so
the port imports nothing of that package.

The reference's processors inherit ``worker`` and ``server`` subcommands
from OCR-D core v3 (reference wrapper/transcode.py:40-46, README.md:
447-450): a *processor server* keeps the processor (and its loaded
model) resident and executes processing requests over HTTP; a
*processing worker* consumes queued jobs.  OCR-D core implements these
on RabbitMQ + MongoDB; this standalone equivalent keeps the same
surface with stdlib machinery:

- ``ProcessorServer``: ``http.server`` HTTP endpoint.  ``GET /info``
  returns the ocrd-tool fragment; ``POST /process`` runs a job given as
  JSON ``{"workspace": dir, "input_file_grp": "A,B",
  "output_file_grp": "OUT", "page_id": "...", "parameter": {...},
  "mets_server_url": "..."}``; ``POST /shutdown`` stops the server.
  Processor instances are cached per parameter set, so the second
  request with the same model skips the h5 load and the jit cache stays
  warm — the whole point of server mode for a device-resident model.
- ``run_worker``: directory-queue worker (the queue broker equivalent):
  claims ``*.json`` job files atomically by rename, executes the same
  job schema, and writes ``<job>.result.json``.

Both run jobs strictly one at a time (the model processors are
single-instance, like the reference's ``max_workers = 1``); parallelism
comes from page-parallel processing inside a job (wrapper/base.py) or
from multiple workers on disjoint workspaces.
"""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


# resident processor instances per server/worker: each distinct
# parameter set may hold a loaded model, so bound the cache (LRU)
CACHE_SIZE = 4


def execute_job(processor_cls, job, cache=None, logger=None):
    """Run one processing job (the /process and worker job schema).
    `cache` maps canonical parameter JSON -> processor instance
    (LRU-bounded at CACHE_SIZE to keep resident model count finite)."""
    params = job.get('parameter') or {}
    key = json.dumps(params, sort_keys=True)
    processor = cache.get(key) if cache is not None else None
    if processor is None:
        processor = processor_cls(parameter=params)
        if cache is not None:
            cache[key] = processor
            while len(cache) > CACHE_SIZE:
                cache.pop(next(iter(cache)))
    elif cache is not None:
        cache[key] = cache.pop(key)    # refresh LRU order
    workspace = job['workspace']
    if job.get('mets_server_url'):
        from ..utils.mets_server import MetsClientWorkspace
        workspace = MetsClientWorkspace(job['mets_server_url'],
                                        directory=workspace)
    page_ids = job.get('page_id')
    if isinstance(page_ids, str):
        # '' (and ',,') mean "all pages", like the CLI's empty -g option
        page_ids = [p for p in page_ids.split(',') if p] or None
    processor.process_workspace(
        workspace, job['input_file_grp'], job.get('output_file_grp'),
        page_ids=page_ids)
    return {'ok': True, 'executable': processor.executable,
            'workspace': job['workspace']}


class ProcessorServer:
    """Persistent HTTP processor server for one PageProcessor class."""

    def __init__(self, processor_cls, address='127.0.0.1:0'):
        self.processor_cls = processor_cls
        host, port = address.rsplit(':', 1)
        self._cache = {}
        self._job_lock = threading.Lock()
        self._stopping = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode('utf-8')
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ('/', '/info'):
                    self._reply(200, {
                        'executable': outer.processor_cls.executable,
                        'parameters': outer.processor_cls.parameter_schema})
                else:
                    self._reply(404, {'error': 'unknown path %s' % self.path})

            def do_POST(self):
                if self.path == '/shutdown':
                    self._reply(200, {'ok': True})
                    outer._stopping = True
                    threading.Thread(target=outer._drain_and_shutdown,
                                     daemon=True).start()
                    return
                if self.path != '/process':
                    self._reply(404, {'error': 'unknown path %s' % self.path})
                    return
                # execute phase: job failures are the client's business
                try:
                    length = int(self.headers.get('Content-Length') or 0)
                    job = json.loads(self.rfile.read(length)
                                     .decode('utf-8'))
                    with outer._job_lock:
                        # the stopping check lives UNDER the job lock:
                        # once _drain_and_shutdown (which sets
                        # _stopping before taking the lock) acquires
                        # it, every committed job has finished and
                        # every later request lands here and gets 503
                        # — no handler can slip between a pre-lock
                        # check and the drain
                        if outer._stopping:
                            self._reply(503, {'error':
                                              'server is shutting down'})
                            return
                        result = execute_job(outer.processor_cls, job,
                                             cache=outer._cache)
                except Exception as exc:
                    try:
                        self._reply(500, {'error': '%s: %s'
                                          % (type(exc).__name__, exc)})
                    except OSError:
                        pass    # client gone; nothing committed anyway
                    return
                # send phase: the job already committed its workspace
                # writes — a dead client socket must NOT be answered
                # with a second (500) response, or the caller would
                # retry a job that succeeded on disk
                try:
                    self._reply(200, result)
                except OSError:
                    pass

        self._server = ThreadingHTTPServer((host or '127.0.0.1',
                                            int(port)), Handler)
        self.address = '%s:%d' % self._server.server_address[:2]
        self._thread = None

    def serve_forever(self):
        try:
            self._server.serve_forever(poll_interval=0.05)
        finally:
            self._server.server_close()

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def _drain_and_shutdown(self):
        # handler threads are daemons (ThreadingHTTPServer), so
        # server_close does NOT join them: wait for an in-flight job's
        # workspace mutation to finish before tearing the server down
        with self._job_lock:
            pass
        self._server.shutdown()

    def stop(self):
        self._stopping = True
        self._drain_and_shutdown()
        if self._thread:
            self._thread.join(timeout=5)


#: a *.json.claimed file older than this (seconds) is treated as a dead
#: worker's orphan and released back into the queue for re-execution
STALE_CLAIM_SECONDS = 900.0


def run_worker(processor_cls, queue_dir, once=False, poll=0.2,
               timeout=None):
    """Consume job files from `queue_dir` until stopped.

    A job is any ``*.json`` file (excluding ``*.result.json``); it is
    claimed by renaming to ``*.json.claimed.<pid>.<tid>.<epoch>``
    (atomic on one filesystem), executed, and answered with
    ``<job>.result.json``.  A claim whose worker died before writing
    the result would be lost forever; claims older than
    ``STALE_CLAIM_SECONDS`` with no result are therefore released back
    into the queue.  The claim time rides IN the suffix so that claim
    creation and claim-age visibility are one atomic rename — a
    separate mtime refresh would leave a window in which a fresh claim
    of a long-queued job still looks stale to another worker's scan,
    double-executing the job.
    `once` returns after the first executed job; `timeout` bounds the
    *idle* wait in seconds (the clock restarts after every executed
    job)."""
    cache = {}
    deadline = time.time() + timeout if timeout is not None else None
    while True:
        claimed = None
        for name in sorted(os.listdir(queue_dir)):
            path = os.path.join(queue_dir, name)
            if '.json.claimed' in name:
                base = path[:path.index('.json.claimed') + len('.json')]
                # claim age comes from the epoch embedded in the
                # suffix (atomic with the claim rename itself);
                # legacy/garbled suffixes fall back to file mtime
                try:
                    claim_time = float(name.rsplit('.', 1)[1])
                except (IndexError, ValueError):
                    try:
                        claim_time = os.path.getmtime(path)
                    except OSError:
                        continue
                if time.time() - claim_time <= STALE_CLAIM_SECONDS:
                    continue
                try:
                    if os.path.exists(base + '.result.json'):
                        os.unlink(path)     # done job: drop the orphan
                    else:
                        os.rename(path, base)   # release for re-run
                except OSError:
                    pass
                continue
            if not name.endswith('.json') or name.endswith('.result.json'):
                continue
            # per-claim unique suffix: this worker's final unlink can
            # only ever remove its OWN claim, never another worker's
            # re-claim of a job that was released while we ran it
            tag = '.claimed.%d.%d.%d' % (os.getpid(),
                                         threading.get_ident(),
                                         int(time.time()))
            try:
                os.rename(path, path + tag)
            except OSError:
                continue    # another worker claimed it first
            claimed = (name, path, tag)
            break
        if claimed is None:
            if deadline is not None and time.time() > deadline:
                return
            time.sleep(poll)
            continue
        name, path, tag = claimed
        try:
            with open(path + tag) as f:
                job = json.load(f)
            result = execute_job(processor_cls, job, cache=cache)
        except Exception as exc:
            result = {'ok': False,
                      'error': '%s: %s' % (type(exc).__name__, exc)}
        with open(path + '.result.json', 'w') as f:
            json.dump(result, f)
        try:
            os.unlink(path + tag)
        except OSError:
            pass    # claim was released as stale while we ran overlong
        if once:
            return
        if deadline is not None:
            deadline = time.time() + timeout


def client_process(address, job):
    """Send one job to a ProcessorServer; returns the reply dict."""
    import http.client
    host, port = address.rsplit(':', 1)
    conn = http.client.HTTPConnection(host or '127.0.0.1', int(port),
                                      timeout=600)
    try:
        conn.request('POST', '/process', json.dumps(job),
                     {'Content-Type': 'application/json'})
        resp = conn.getresponse()
        payload = json.loads(resp.read().decode('utf-8'))
        if resp.status != 200:
            raise RuntimeError('processor server: %s'
                               % payload.get('error', resp.status))
        return payload
    finally:
        conn.close()
