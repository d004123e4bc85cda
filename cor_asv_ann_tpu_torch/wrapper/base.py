"""Standalone processor base for PAGE-XML workspace processing.

A copy of the JAX package's ``wrapper/base.py`` (host code), kept here so
the port imports nothing of that package.

The reference's processors run on OCR-D core (`ocrd.Processor` with METS
workspaces, worker/server modes; reference wrapper/*.py). This framework
ships its own thin runner so the same processing logic works without the
ocrd stack: a `PageProcessor` iterates the pages of a workspace (METS or
bare directory, utils/workspace.py), feeds parsed PAGE documents to
`process_page`, and stores results under the output fileGrp.

Parameters are validated against the processor's `ocrd-tool`-style schema
(defaults/enum/required), mirroring OCR-D parameter semantics.
"""

import json
import logging
import os
import threading

from ..utils.page import parse_page
from ..utils.workspace import Workspace


class ParameterError(ValueError):
    pass


def validate_parameters(schema, params):
    """Apply defaults and validate against an ocrd-tool parameter schema."""
    out = {}
    params = dict(params or {})
    for name, spec in schema.items():
        if name in params:
            value = params.pop(name)
        elif 'default' in spec:
            value = spec['default']
        elif spec.get('required'):
            raise ParameterError('missing required parameter "%s"' % name)
        else:
            continue
        typ = spec.get('type')
        if typ == 'number':
            value = float(value)
        elif typ == 'boolean':
            value = bool(value) if not isinstance(value, str) \
                else value.lower() in ('1', 'true', 'yes')
        elif typ == 'string' and not isinstance(value, str):
            value = str(value)
        if 'enum' in spec and value not in spec['enum']:
            raise ParameterError('parameter "%s" must be one of %s, got %r'
                                 % (name, spec['enum'], value))
        out[name] = value
    if params:
        raise ParameterError('unknown parameters: %s' % list(params))
    return out


class PageProcessor:
    """Base class: subclasses define `executable`, `parameter_schema`, and
    either `process_page(pcgts_list, page_id) -> PageDoc or None`."""

    executable = None
    parameter_schema = {}
    # how many input fileGrps are accepted (min, max); None = unbounded
    input_file_grp_cardinality = (1, 1)
    # page-parallel cap: None = any (stateless per page), 1 = strictly
    # serial (model-holding / document-aggregating processors, like the
    # reference's max_workers = 1, reference transcode.py:46,
    # evaluate.py:29)
    max_workers = None

    def __init__(self, parameter=None, logger=None):
        self.logger = logger or logging.getLogger(
            self.executable or self.__class__.__name__)
        self.parameter = validate_parameters(self.parameter_schema,
                                             parameter)
        # guards cross-page aggregation state under page-parallel runs
        self._lock = threading.Lock()
        self.setup()

    def setup(self):
        pass

    def verify(self, input_grps):
        lo, hi = self.input_file_grp_cardinality
        if len(input_grps) < lo or (hi is not None and len(input_grps) > hi):
            raise ParameterError(
                '%s requires between %s and %s input fileGrps, got %d'
                % (self.executable, lo, hi, len(input_grps)))

    def _parallel_pages(self, n_pages):
        """Page-parallel worker count: OCRD_MAX_PARALLEL_PAGES (the
        reference's env var, conftest.py:75-83) clamped by this
        processor's `max_workers` and the page count."""
        try:
            want = int(os.environ.get('OCRD_MAX_PARALLEL_PAGES') or 1)
        except ValueError:
            want = 1
        if self.max_workers is not None:
            want = min(want, self.max_workers)
        return max(1, min(want, n_pages))

    def process_workspace(self, workspace, input_grps, output_grp,
                          page_ids=None):
        """Iterate pages; parse one PAGE doc per input fileGrp; store the
        result document (if any) under `output_grp`.

        With OCRD_MAX_PARALLEL_PAGES > 1 (and `max_workers` allowing),
        pages are parsed and processed in a thread pool; results are
        registered incrementally in deterministic page order, so a METS
        server (utils/mets_server.py) or the in-process Workspace sees
        exactly the serial sequence of writes, and a failing page leaves
        every earlier page's output registered (like the serial path)."""
        if isinstance(workspace, str):
            workspace = Workspace(workspace)
        if isinstance(input_grps, str):
            input_grps = input_grps.split(',')
        self.verify(input_grps)
        grp_files = [workspace.page_files(grp) for grp in input_grps]
        missing = [g for g, files in zip(input_grps, grp_files)
                   if not files]
        if missing:
            raise ParameterError('input fileGrp(s) %s contain no page '
                                 'files' % missing)
        pages = page_ids or [p for p in workspace.page_ids()
                             if p in grp_files[0]]
        self.start_document(workspace, input_grps, output_grp)

        def handle_page(page_id):
            docs = []
            for files in grp_files:
                if page_id in files:
                    docs.append(parse_page(files[page_id].path))
                else:
                    docs.append(None)
            if docs[0] is None:
                self.logger.error('page "%s" missing from fileGrp %s',
                                  page_id, input_grps[0])
                return None
            return self.process_page(docs, page_id)

        def register(page_id, result):
            if result is not None and output_grp:
                workspace.add_file(output_grp, page_id, result.to_bytes(),
                                   file_id='%s_%s' % (output_grp, page_id))

        parallel = self._parallel_pages(len(pages))
        if parallel > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=parallel) as pool:
                # pool.map yields in page order as results complete, so
                # each finished page is registered before the next is
                # awaited — an exception on page k propagates with pages
                # < k already registered, exactly like the serial path
                for page_id, result in zip(pages,
                                           pool.map(handle_page, pages)):
                    register(page_id, result)
        else:
            for page_id in pages:
                register(page_id, handle_page(page_id))
        self.end_document(workspace, input_grps, output_grp)
        workspace.save()

    def start_document(self, workspace, input_grps, output_grp):
        pass

    def end_document(self, workspace, input_grps, output_grp):
        pass

    def process_page(self, docs, page_id):
        raise NotImplementedError


def processor_cli(processor_cls):
    """Build a click CLI for a PageProcessor (OCR-D-style options).

    Besides direct processing, the CLI carries the reference's
    ``worker`` and ``server`` subcommands (reference README.md:447-450;
    OCR-D core v3 surface) in their standalone forms
    (wrapper/server.py), and ``-U/--mets-server-url`` for running
    against a METS server (utils/mets_server.py)."""
    import click

    def _setup_logging():
        logging.basicConfig(
            format='%(asctime)s.%(msecs)03d %(levelname)s %(name)s - '
                   '%(message)s', datefmt='%H:%M:%S', level=logging.INFO)

    @click.group(invoke_without_command=True,
                 context_settings=dict(help_option_names=['-h', '--help']))
    @click.option('-I', '--input-file-grp', default=None,
                  help='comma-separated input fileGrp(s)')
    @click.option('-O', '--output-file-grp', default=None,
                  help='output fileGrp')
    @click.option('-p', '--parameter', default='{}',
                  help='JSON parameter object or @file')
    @click.option('-P', '--parameter-override', nargs=2, multiple=True,
                  help='single parameter override (name value)')
    @click.option('-g', '--page-id', default=None,
                  help='comma-separated page ids to process')
    @click.option('-m', '--mets', 'directory', default='.',
                  help='workspace directory (containing mets.xml) '
                       'or bare PAGE-XML directory')
    @click.option('-U', '--mets-server-url', default=None,
                  help='METS server address (unix socket path or '
                       'host:port) to use instead of direct mets.xml '
                       'access')
    @click.pass_context
    def cli(ctx, input_file_grp, output_file_grp, parameter,
            parameter_override, page_id, directory, mets_server_url):
        if ctx.invoked_subcommand is not None:
            return
        if not input_file_grp:
            raise click.UsageError('-I/--input-file-grp is required')
        _setup_logging()
        if parameter.startswith('@'):
            with open(parameter[1:]) as f:
                params = json.load(f)
        else:
            params = json.loads(parameter)
        for name, value in parameter_override:
            try:
                params[name] = json.loads(value)
            except json.JSONDecodeError:
                params[name] = value
        proc = processor_cls(parameter=params)
        workspace = directory
        if mets_server_url:
            from ..utils.mets_server import MetsClientWorkspace
            workspace = MetsClientWorkspace(mets_server_url,
                                            directory=directory)
        proc.process_workspace(workspace, input_file_grp, output_file_grp,
                               page_ids=page_id.split(',') if page_id
                               else None)

    @cli.command()
    @click.option('--address', default='127.0.0.1:0',
                  help='host:port to listen on (port 0 = ephemeral)')
    def server(address):
        """Run as a persistent processor server (model stays loaded;
        POST /process jobs; see wrapper/server.py)."""
        _setup_logging()
        from .server import ProcessorServer
        srv = ProcessorServer(processor_cls, address)
        click.echo('%s server listening on %s'
                   % (processor_cls.executable, srv.address))
        srv.serve_forever()

    @cli.command()
    @click.option('--queue', required=True,
                  help='job queue directory (one JSON file per job)')
    @click.option('--once', is_flag=True,
                  help='process a single job, then exit')
    @click.option('--timeout', type=float, default=None,
                  help='exit after this many idle seconds')
    def worker(queue, once, timeout):
        """Run as a processing worker on a directory job queue
        (standalone stand-in for OCR-D's queue broker; see
        wrapper/server.py)."""
        _setup_logging()
        from .server import run_worker
        run_worker(processor_cls, queue, once=once, timeout=timeout)

    cli.__doc__ = processor_cls.__doc__
    return cli
