"""Optional OCR-D core integration for the five workspace processors.

A copy of the JAX package's ``wrapper/ocrd_adapter.py`` (host code),
kept here so the port imports nothing of that package.

The reference ships its processors as ``ocrd.Processor`` subclasses
(reference wrapper/transcode.py:40-46 etc.), gaining OCR-D's workflow
runner, METS server, worker/server modes and resource manager.  This
framework's processors run standalone (wrapper/base.py); when the
``ocrd`` package IS importable, this module bridges them onto OCR-D
core so ``ocrd process``-style workflows can drive them unchanged.

The bridge is built lazily (``make_processor_class`` imports ``ocrd``
at call time) so that

- environments without ocrd import this module without error
  (``available()`` is False, the standalone CLIs keep working),
- tests can exercise the full bridge protocol against a minimal stub
  of the ocrd API (tests/test_ocrd_adapter.py).

Page payloads cross the boundary as serialized PAGE-XML: OCR-D's
``OcrdPage`` object trees are rendered with ocrd's own ``to_xml`` and
re-parsed by the first-party PAGE layer (utils/page.py), and results
travel back the same way — no structural mirroring of the ocrd object
model is needed, and both sides stay authoritative for their own
parsing.
"""

import importlib
import os


def available():
    """True when the real OCR-D core stack is importable."""
    try:
        importlib.import_module('ocrd')
        importlib.import_module('ocrd_models.ocrd_page')
        return True
    except ImportError:
        return False


def make_processor_class(page_processor_cls, ocrd_module=None,
                         page_module=None):
    """Build an ``ocrd.Processor`` subclass wrapping a PageProcessor.

    `ocrd_module`/`page_module` default to the installed ``ocrd`` /
    ``ocrd_models.ocrd_page``; tests pass stubs.  The returned class
    follows the OCR-D v3 protocol the reference uses: ``executable``
    property, ``setup()`` building the inner processor once, and
    ``process_page_pcgts(*input_pcgts, page_id=...)`` returning an
    ``OcrdPageResult``.
    """
    from ..utils.page import parse_page

    ocrd = ocrd_module or importlib.import_module('ocrd')
    ocrd_page = page_module or importlib.import_module(
        'ocrd_models.ocrd_page')

    class _WorkspaceShim:
        """Maps the slice of the first-party Workspace duck type that
        document-level flushers use (add_file, evaluate.py end_document)
        onto an OCR-D core Workspace (v3 keyword signature)."""

        def __init__(self, ocrd_workspace):
            self._ws = ocrd_workspace

        def add_file(self, group, page_id, content, file_id=None,
                     mimetype='application/vnd.prima.page+xml',
                     ext='.xml'):
            if isinstance(content, str):
                content = content.encode('utf-8')
            file_id = file_id or '%s_%s' % (group, page_id or 'doc')
            return self._ws.add_file(
                group, file_id=file_id, page_id=page_id,
                mimetype=mimetype, content=content,
                local_filename=os.path.join(group, file_id + ext))

    class BridgedProcessor(ocrd.Processor):
        @property
        def executable(self):
            return page_processor_cls.executable

        def setup(self):
            self._inner = page_processor_cls(
                parameter=dict(self.parameter or {}),
                logger=getattr(self, 'logger', None))
            self._document_started = False

        def _start_document_once(self, n_inputs):
            # OCR-D core drives document iteration itself and only calls
            # the per-page hook, so document-scope state the standalone
            # runner would seed via start_document (input fileGrp names,
            # aggregate stats — EvaluateLines/JoinLines) is seeded here
            # from the core Processor's own attributes on first page
            if self._document_started:
                return
            grps = getattr(self, 'input_file_grp', None) or ''
            grps = [g for g in grps.split(',') if g]
            if len(grps) != n_inputs:
                grps = (grps + ['input-%d' % i for i in range(n_inputs)]
                        )[:n_inputs]
            self._doc_grps = grps
            output_grp = getattr(self, 'output_file_grp', None)
            self._inner.start_document(None, grps, output_grp)
            # processors that emit per-page workspace files outside the
            # PAGE result (EvaluateLines' per-page JSON reports,
            # reference evaluate.py:318-324) check their _workspace
            # attribute from process_page; route those into core's
            # workspace so bridge output matches the standalone runner
            workspace = getattr(self, 'workspace', None)
            if workspace is not None and output_grp and \
                    hasattr(self._inner, '_workspace'):
                self._inner._workspace = _WorkspaceShim(workspace)
                self._inner._output_grp = output_grp
            self._document_started = True

        def process_page_pcgts(self, *input_pcgts, page_id=None):
            docs = [parse_page(ocrd_page.to_xml(pcgts))
                    if pcgts is not None else None
                    for pcgts in input_pcgts]
            self._start_document_once(len(docs))
            if docs[0] is None:
                # the standalone runner's docs[0] guard (base.py): the
                # primary fileGrp must have the page; raise a clear
                # error for core to log instead of crashing the inner
                # processor on a None document
                raise ValueError(
                    'page %r missing from the primary input fileGrp'
                    % (page_id,))
            result = self._inner.process_page(docs, page_id)
            if result is None:
                result = docs[0]
            out = ocrd_page.parseString(result.to_bytes())
            return ocrd.OcrdPageResult(out)

        def shutdown(self):
            # flush document-level aggregation (e.g. EvaluateLines'
            # summary report) when core tears the processor down;
            # route the report file into core's own workspace when one
            # is attached (self.workspace during core processing)
            if getattr(self, '_document_started', False):
                workspace = getattr(self, 'workspace', None)
                output_grp = getattr(self, 'output_file_grp', None)
                if workspace is not None and output_grp:
                    self._inner.end_document(
                        _WorkspaceShim(workspace),
                        getattr(self, '_doc_grps', None), output_grp)
                else:
                    self._inner.end_document(None, None, None)
                self._document_started = False
            parent = getattr(super(), 'shutdown', None)
            if parent is not None:
                parent()

    BridgedProcessor.__name__ = 'Ocrd' + page_processor_cls.__name__
    BridgedProcessor.__qualname__ = BridgedProcessor.__name__
    BridgedProcessor.__doc__ = page_processor_cls.__doc__
    return BridgedProcessor


def _bridged(executable_module, class_name):
    """Import-on-demand bridge factory for one processor."""
    def build(ocrd_module=None, page_module=None):
        mod = importlib.import_module(
            'cor_asv_ann_tpu_torch.wrapper.' + executable_module)
        return make_processor_class(getattr(mod, class_name),
                                    ocrd_module, page_module)
    return build


# the five reference processors (reference pyproject.toml:37-41)
BRIDGES = {
    'ocrd-cor-asv-ann-process': _bridged('transcode', 'ANNCorrection'),
    'ocrd-cor-asv-ann-evaluate': _bridged('evaluate', 'EvaluateLines'),
    'ocrd-cor-asv-ann-align': _bridged('align', 'AlignLines'),
    'ocrd-cor-asv-ann-join': _bridged('join', 'JoinLines'),
    'ocrd-cor-asv-ann-mark': _bridged('mark', 'MarkWords'),
}


def cli(executable):
    """OCR-D CLI for `executable` (used when ocrd core is installed):
    builds the bridged Processor and hands it to ocrd's own CLI wrapper
    (the reference's ocrd_cli_wrap_processor pattern)."""
    if not available():
        raise RuntimeError(
            'the ocrd package is not installed; use the standalone '
            'CLI (%s via cor_asv_ann_tpu_torch.wrapper) instead' % executable)
    import click
    from ocrd.decorators import ocrd_cli_options, ocrd_cli_wrap_processor

    cls = BRIDGES[executable]()

    @click.command(name=executable)
    @ocrd_cli_options
    def _cli(*args, **kwargs):
        return ocrd_cli_wrap_processor(cls, *args, **kwargs)

    return _cli
