"""Standalone METS server: concurrent workspace metadata access.

A copy of the JAX package's ``utils/mets_server.py`` (host code), kept here so
the port imports nothing of that package.

The reference's processors lean on OCR-D core's ``OcrdMetsServer`` for
page-parallel processing: one process owns the ``mets.xml`` and serves
reads/writes over a unix socket so that parallel page workers never
corrupt the file (reference tests/conftest.py:84-99, README.md:447-450,
468-470).  This is the first-party equivalent for the standalone
workspace layer (utils/workspace.py): a tiny JSON-per-line request
protocol over a unix-domain socket (or TCP ``host:port``), a threaded
server that serializes all METS mutations behind one lock, and a client
class that duck-types the ``Workspace`` interface so every
``PageProcessor`` can run against it unchanged (``-U/--mets-server-url``
on the processor CLIs, wrapper/base.py).

Design notes (host subsystem):

- File *content* travels through the socket base64-encoded and the
  server writes it to disk.  Workers therefore never touch mets.xml or
  the output tree themselves — one writer, no locks on the client side.
- One request per connection (connect, send one JSON line, read one
  JSON line, close).  Page metadata payloads are tiny compared to model
  compute; simplicity beats connection reuse here.
- ``save`` is explicit, as with the in-process Workspace; ``stop``
  additionally persists before shutdown so a crashed client cannot
  leave a half-written METS.
"""

import base64
import json
import os
import socket
import socketserver
import threading

from .workspace import Workspace, WorkspaceFile, index_page_files


def parse_address(address):
    """'host:port' -> (AF_INET, (host, int(port))); otherwise a unix
    socket path -> (AF_UNIX, path)."""
    if isinstance(address, tuple):
        return socket.AF_INET, address
    address = str(address)
    if address.startswith('unix://'):
        address = address[len('unix://'):]
    if os.sep in address or address.startswith('.'):
        return socket.AF_UNIX, address
    if ':' in address:
        host, port = address.rsplit(':', 1)
        return socket.AF_INET, (host or '127.0.0.1', int(port))
    return socket.AF_UNIX, address


class _Handler(socketserver.StreamRequestHandler):
    # a connected-but-silent client must not pin a handler thread in
    # readline() forever; StreamRequestHandler.setup applies this as a
    # socket timeout.  Handler threads are additionally daemonic (see
    # MetsServer.__init__) so server_close never joins on a wedged
    # client — METS state is safe either way because every mutation is
    # serialized behind the dispatch lock and persisted in
    # serve_forever's finally
    timeout = 30.0

    def handle(self):
        try:
            line = self.rfile.readline()
        except OSError:     # includes socket.timeout: drop the client
            return
        if not line:
            return
        try:
            request = json.loads(line.decode('utf-8'))
            result = self.server.dispatch(request.get('method'),
                                          request.get('params') or {})
            reply = {'result': result}
        except Exception as exc:   # protocol boundary: report, don't die
            reply = {'error': '%s: %s' % (type(exc).__name__, exc)}
        self.wfile.write(json.dumps(reply).encode('utf-8') + b'\n')


class MetsServer:
    """Owns a Workspace; serves reads and serialized writes."""

    def __init__(self, directory, address):
        self.workspace = Workspace(directory)
        self.family, self.address = parse_address(address)
        self._lock = threading.Lock()
        if self.family == socket.AF_UNIX:
            if os.path.exists(self.address):
                os.unlink(self.address)
            cls = type('UnixServer',
                       (socketserver.ThreadingMixIn,
                        socketserver.UnixStreamServer),
                       {'daemon_threads': True})
        else:
            cls = type('TcpServer',
                       (socketserver.ThreadingMixIn,
                        socketserver.TCPServer),
                       {'allow_reuse_address': True,
                        'daemon_threads': True})
        self._server = cls(self.address, _Handler)
        if self.family != socket.AF_UNIX:
            # read back the ACTUAL bound address: 'host:0' asks the OS
            # for an ephemeral port, which clients must learn from here
            self.address = self._server.server_address[:2]
        self._server.dispatch = self.dispatch
        self._thread = None

    # -- protocol methods ---------------------------------------------
    def dispatch(self, method, params):
        # requests run on ThreadingMixIn handler threads; the whole
        # dispatch is serialized — reads too, since a reader iterating
        # the METS tree must not observe a half-built element another
        # thread's add_file is constructing
        with self._lock:
            return self._dispatch_locked(method, params)

    def _dispatch_locked(self, method, params):
        if method == 'file_groups':
            return self.workspace.file_groups()
        if method == 'page_ids':
            return self.workspace.page_ids()
        if method == 'files':
            return [{'id': f.id, 'group': f.group, 'page_id': f.page_id,
                     'path': f.path, 'mimetype': f.mimetype}
                    for f in self.workspace.files(
                        group=params.get('group'),
                        page_id=params.get('page_id'),
                        mimetype=params.get('mimetype'))]
        if method == 'add_file':
            content = base64.b64decode(params['content_b64'])
            return self.workspace.add_file(
                params['group'], params['page_id'], content,
                file_id=params.get('file_id'),
                mimetype=params.get('mimetype')
                or 'application/vnd.prima.page+xml',
                ext=params.get('ext') or '.xml')
        if method == 'save':
            self.workspace.save()
            return None
        if method == 'stop':
            self.workspace.save()
            threading.Thread(target=self._server.shutdown,
                             daemon=True).start()
            return None
        raise ValueError('unknown method %r' % (method,))

    # -- lifecycle ----------------------------------------------------
    def serve_forever(self):
        try:
            self._server.serve_forever(poll_interval=0.05)
        finally:
            self._server.server_close()
            # server_close joins the handler threads: a writer that
            # acquired the dispatch lock AFTER the 'stop' handler's
            # save was acknowledged with success — persist its work
            with self._lock:
                self.workspace.save()
            if self.family == socket.AF_UNIX and \
                    os.path.exists(self.address):
                os.unlink(self.address)

    def start(self):
        """Serve on a daemon thread (in-process use; tests, CLIs)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


#: seconds before a client call to a hung/killed METS server errors out
#: instead of blocking a page worker forever (override per call if a
#: single request can legitimately run longer)
CALL_TIMEOUT = 120.0


def _call(family, address, method, timeout=None, **params):
    with socket.socket(family, socket.SOCK_STREAM) as sock:
        sock.settimeout(CALL_TIMEOUT if timeout is None else timeout)
        try:
            sock.connect(address)
            sock.sendall(json.dumps({'method': method, 'params': params})
                         .encode('utf-8') + b'\n')
            chunks = []
            while True:
                chunk = sock.recv(1 << 16)
                if not chunk:
                    break
                chunks.append(chunk)
                if chunk.endswith(b'\n'):
                    break
        except socket.timeout:
            raise RuntimeError(
                'METS server at %r did not answer %r within %.0fs (server '
                'hung or overloaded?)' % (address, method,
                                          CALL_TIMEOUT if timeout is None
                                          else timeout)) from None
        except ConnectionError as err:
            # a dying server can reset instead of FIN-closing the socket
            raise RuntimeError(
                'METS server at %r closed the connection without replying '
                'to %r (%s; server died?)' % (address, method, err)) \
                from None
    raw = b''.join(chunks)
    if not raw.strip():
        raise RuntimeError(
            'METS server at %r closed the connection without replying to '
            '%r (server died?)' % (address, method))
    try:
        reply = json.loads(raw.decode('utf-8'))
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        raise RuntimeError(
            'METS server at %r sent a truncated/invalid reply to %r: %s'
            % (address, method, err)) from None
    if 'error' in reply:
        raise RuntimeError('METS server: ' + reply['error'])
    return reply['result']


class MetsClientWorkspace:
    """Workspace facade backed by a MetsServer (same duck type as
    utils.workspace.Workspace, so PageProcessor runs unchanged).

    `timeout` overrides the per-request CALL_TIMEOUT for this client —
    the public way to allow legitimately long requests (huge workspace
    save, big add_file payloads over slow links)."""

    def __init__(self, address, directory=None, timeout=None):
        self.family, self.address = parse_address(address)
        self.directory = directory
        self.timeout = timeout

    def _call(self, method, **params):
        return _call(self.family, self.address, method,
                     timeout=self.timeout, **params)

    def file_groups(self):
        return self._call('file_groups')

    def page_ids(self):
        return self._call('page_ids')

    def files(self, group=None, page_id=None, mimetype=None):
        return [WorkspaceFile(d['id'], d['group'], d['page_id'],
                              d['path'], d['mimetype'])
                for d in self._call('files', group=group, page_id=page_id,
                                    mimetype=mimetype)]

    def page_files(self, group):
        return index_page_files(self.files(group=group))

    def add_file(self, group, page_id, content, file_id=None,
                 mimetype='application/vnd.prima.page+xml', ext='.xml'):
        if isinstance(content, str):
            content = content.encode('utf-8')
        return self._call(
            'add_file', group=group, page_id=page_id,
            content_b64=base64.b64encode(content).decode('ascii'),
            file_id=file_id, mimetype=mimetype, ext=ext)

    def save(self):
        self._call('save')

    def stop_server(self):
        self._call('stop')


def main(argv=None):
    """``python -m cor_asv_ann_tpu_torch.utils.mets_server DIR -U ADDRESS``
    (the standalone equivalent of ``ocrd workspace -U ... server start``,
    reference README.md:468-470)."""
    import argparse
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument('directory', help='workspace directory')
    parser.add_argument('-U', '--address', required=True,
                        help='unix socket path or host:port')
    args = parser.parse_args(argv)
    server = MetsServer(args.directory, args.address)
    address = server.address
    if isinstance(address, tuple):
        address = '%s:%d' % address[:2]
    print('METS server for %s listening on %s' %
          (args.directory, address), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == '__main__':
    main()
