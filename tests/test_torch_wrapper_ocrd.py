"""PyTorch port: the OCR-D core adapter against a minimal stub of the
ocrd API.

Counterparts of tests/test_ocrd_adapter.py for the port's copy of
``wrapper/ocrd_adapter.py`` (``ocrd`` is not installed, so the bridge
runs against a stub of exactly the surface it uses: ``ocrd.Processor``,
``OcrdPageResult`` and ``ocrd_models.ocrd_page``'s ``to_xml`` /
``parseString``). The bridges import the port's processors, and the
bridged ocrd-cor-asv-ann-process passes its ``device`` parameter on.
"""

import logging
import types

import pytest

from cor_asv_ann_tpu_torch.utils import page as P
from cor_asv_ann_tpu_torch.wrapper import ocrd_adapter


class StubPage:
    """Stands in for ocrd_models' OcrdPage: wraps serialized PAGE-XML."""

    def __init__(self, xml):
        self.xml = xml


class StubProcessor:
    """The slice of ocrd.Processor the bridge relies on."""

    def __init__(self, parameter=None):
        self.parameter = parameter or {}
        self.logger = logging.getLogger('stub')
        self.setup()

    def setup(self):
        pass


class StubResult:
    def __init__(self, pcgts):
        self.pcgts = pcgts


def make_stub_modules():
    ocrd = types.SimpleNamespace(Processor=StubProcessor,
                                 OcrdPageResult=StubResult)
    ocrd_page = types.SimpleNamespace(
        to_xml=lambda p: p.xml,
        parseString=lambda data: StubPage(
            data.decode('utf-8') if isinstance(data, bytes) else data))
    return ocrd, ocrd_page


def _page_with_line(text):
    doc = P.new_page()
    region = P.add_region(doc, 'r1')
    line = P.add_line(region, 'l1')
    line.add_textequiv(text)
    return doc


def test_bridge_protocol_mark():
    """The bridged MarkWords runs through the ocrd-style protocol:
    parameter passthrough, setup, page conversion both ways."""
    ocrd, ocrd_page = make_stub_modules()
    cls = ocrd_adapter.BRIDGES['ocrd-cor-asv-ann-mark'](
        ocrd_module=ocrd, page_module=ocrd_page)
    assert cls.__name__ == 'OcrdMarkWords'
    # 'false' lookup prints nothing -> every word counts as known
    proc = cls(parameter={'command': 'cat >/dev/null', 'format': 'BAD'})
    assert proc.executable == 'ocrd-cor-asv-ann-mark'

    doc = _page_with_line('Der Hund')
    # the standalone mark processor needs Word elements
    line = doc.get_lines()[0]
    for i, token in enumerate(['Der', 'Hund']):
        word = P.add_word(line, 'w%d' % i)
        word.add_textequiv(token)
    stub_in = StubPage(doc.to_bytes().decode('utf-8'))
    result = proc.process_page_pcgts(stub_in, page_id='p1')
    assert isinstance(result, StubResult)
    roundtrip = P.parse_page(result.pcgts.xml)
    texts = [w.get_textequivs()[0].unicode
             for w in roundtrip.get_lines()[0].get_words()]
    assert texts == ['Der', 'Hund']


def test_bridge_marks_unknown_words():
    """An always-unknown lookup command marks every word through the
    full ocrd-style round trip."""
    ocrd, ocrd_page = make_stub_modules()
    cls = ocrd_adapter.BRIDGES['ocrd-cor-asv-ann-mark'](
        ocrd_module=ocrd, page_module=ocrd_page)
    proc = cls(parameter={'command': 'cat', 'format': 'UNKNOWN'})
    doc = _page_with_line('Der Hund')
    line = doc.get_lines()[0]
    for i, token in enumerate(['Der', 'Hund']):
        word = P.add_word(line, 'w%d' % i)
        word.add_textequiv(token)
    result = proc.process_page_pcgts(
        StubPage(doc.to_bytes().decode('utf-8')), page_id='p1')
    roundtrip = P.parse_page(result.pcgts.xml)
    comments = [w.get_textequivs()[0].comments
                for w in roundtrip.get_lines()[0].get_words()]
    assert comments == ['UNKNOWN', 'UNKNOWN']


def test_bridge_evaluate_runs_per_page():
    """The bridged EvaluateLines must run through the per-page protocol
    (OCR-D core never calls start_document/process_workspace): document
    state is seeded lazily from the core Processor's fileGrp attributes,
    pages aggregate, and shutdown() flushes the document report."""
    ocrd, ocrd_page = make_stub_modules()
    cls = ocrd_adapter.BRIDGES['ocrd-cor-asv-ann-evaluate'](
        ocrd_module=ocrd, page_module=ocrd_page)
    proc = cls(parameter={'metric': 'Levenshtein'})
    proc.input_file_grp = 'GT,OCR'
    gt = StubPage(_page_with_line('Der Hund').to_bytes().decode('utf-8'))
    ocr = StubPage(_page_with_line('Der Hvnd').to_bytes().decode('utf-8'))
    result = proc.process_page_pcgts(gt, ocr, page_id='p1')
    assert isinstance(result, StubResult)
    # second page keeps aggregating into the same document stats
    proc.process_page_pcgts(gt, ocr, page_id='p2')
    proc.shutdown()
    report = proc._inner.report
    assert 'OCR,GT' in report
    assert report['OCR,GT']['num-lines'] == 2
    # 1 substitution in 8 chars on each page
    assert report['OCR,GT']['char-error-rate-mean'] == \
        pytest.approx(1 / 8)


def test_bridge_join_filegrp_comments():
    """The bridged JoinLines tags joined TextEquivs with real fileGrp
    names taken from the core Processor's input_file_grp attribute."""
    ocrd, ocrd_page = make_stub_modules()
    cls = ocrd_adapter.BRIDGES['ocrd-cor-asv-ann-join'](
        ocrd_module=ocrd, page_module=ocrd_page)
    proc = cls(parameter={'add-filegrp-comments': True})
    proc.input_file_grp = 'GT,OCR'
    a = StubPage(_page_with_line('Der Hund').to_bytes().decode('utf-8'))
    b = StubPage(_page_with_line('Der Hvnd').to_bytes().decode('utf-8'))
    result = proc.process_page_pcgts(a, b, page_id='p1')
    joined = P.parse_page(result.pcgts.xml)
    equivs = joined.get_lines()[0].get_textequivs()
    assert [(e.unicode, e.comments) for e in equivs] == \
        [('Der Hund', 'GT'), ('Der Hvnd', 'OCR')]


def test_bridge_join_without_grp_names():
    """Without fileGrp attributes on the core Processor, the bridge
    falls back to positional names instead of crashing."""
    ocrd, ocrd_page = make_stub_modules()
    cls = ocrd_adapter.BRIDGES['ocrd-cor-asv-ann-join'](
        ocrd_module=ocrd, page_module=ocrd_page)
    proc = cls(parameter={'add-filegrp-comments': True})
    a = StubPage(_page_with_line('aa').to_bytes().decode('utf-8'))
    b = StubPage(_page_with_line('ab').to_bytes().decode('utf-8'))
    result = proc.process_page_pcgts(a, b, page_id='p1')
    joined = P.parse_page(result.pcgts.xml)
    comments = [e.comments
                for e in joined.get_lines()[0].get_textequivs()]
    assert comments == ['input-0', 'input-1']


def test_all_five_processors_bridge():
    """Every reference processor executable has a buildable bridge."""
    ocrd, ocrd_page = make_stub_modules()
    for executable, build in ocrd_adapter.BRIDGES.items():
        cls = build(ocrd_module=ocrd, page_module=ocrd_page)
        assert issubclass(cls, StubProcessor), executable


def test_available_without_ocrd():
    assert not ocrd_adapter.available()
    with pytest.raises(RuntimeError, match='cor_asv_ann_tpu_torch.wrapper'):
        ocrd_adapter.cli('ocrd-cor-asv-ann-mark')


def test_bridge_evaluate_flushes_report_file():
    """With an output fileGrp and a core workspace attached, shutdown()
    must write the aggregate report through core's own add_file (the
    standalone runner's end_document deliverable)."""
    ocrd, ocrd_page = make_stub_modules()
    cls = ocrd_adapter.BRIDGES['ocrd-cor-asv-ann-evaluate'](
        ocrd_module=ocrd, page_module=ocrd_page)
    proc = cls(parameter={'metric': 'Levenshtein'})
    proc.input_file_grp = 'GT,OCR'
    proc.output_file_grp = 'EVAL'

    added = []

    class StubWorkspace:
        # OCR-D core v3 Workspace.add_file keyword surface
        def add_file(self, file_grp, file_id=None, page_id=None,
                     mimetype=None, content=None, local_filename=None):
            added.append((file_grp, file_id, page_id, mimetype,
                          content, local_filename))

    proc.workspace = StubWorkspace()
    gt = StubPage(_page_with_line('Der Hund').to_bytes().decode('utf-8'))
    ocr = StubPage(_page_with_line('Der Hvnd').to_bytes().decode('utf-8'))
    proc.process_page_pcgts(gt, ocr, page_id='p1')
    proc.shutdown()
    # one per-page report (reference evaluate.py:318-324) + one
    # document-level report at shutdown
    assert len(added) == 2
    grp, file_id, page_id, mimetype, content, local = added[0]
    assert grp == 'EVAL' and page_id == 'p1'
    assert mimetype == 'application/json'
    import json
    page_report = json.loads(content)
    assert 'OCR,GT' in page_report
    grp, file_id, page_id, mimetype, content, local = added[1]
    assert grp == 'EVAL' and page_id is None
    assert mimetype == 'application/json'
    report = json.loads(content)
    assert report['OCR,GT']['num-lines'] == 1


def test_bridge_missing_primary_page_raises_cleanly():
    """A None primary input document (page absent from the first
    fileGrp) raises a clear ValueError instead of crashing the inner
    processor (mirrors the standalone runner's docs[0] guard)."""
    ocrd, ocrd_page = make_stub_modules()
    cls = ocrd_adapter.BRIDGES['ocrd-cor-asv-ann-join'](
        ocrd_module=ocrd, page_module=ocrd_page)
    proc = cls(parameter={})
    b = StubPage(_page_with_line('ab').to_bytes().decode('utf-8'))
    with pytest.raises(ValueError, match='missing from the primary'):
        proc.process_page_pcgts(None, b, page_id='p9')


def test_bridges_build_the_ports_processors():
    """Every model-free bridge wraps the port's processor class, never the
    JAX package's (the process bridge: the test below)."""
    ocrd, ocrd_page = make_stub_modules()
    params = {'ocrd-cor-asv-ann-mark': {'command': 'cat'}}
    for executable, build in ocrd_adapter.BRIDGES.items():
        if executable == 'ocrd-cor-asv-ann-process':
            continue
        cls = build(ocrd_module=ocrd, page_module=ocrd_page)
        inner = cls(parameter=params.get(executable, {}))._inner
        assert type(inner).__module__.startswith(
            'cor_asv_ann_tpu_torch.wrapper.'), executable


def test_bridge_process_passes_device(tmp_path):
    """The bridged ocrd-cor-asv-ann-process builds the port's model on the
    device its parameter names and corrects a page through the ocrd-style
    round trip like the standalone processor."""
    import os
    from cor_asv_ann_tpu_torch.wrapper.transcode import ANNCorrection
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = {'model_file': os.path.join(
        root, 'testmodels', 'reference_trained.w64.h5'),
        'textequiv_level': 'word', 'fast_mode': True, 'device': 'cpu'}
    ocrd, ocrd_page = make_stub_modules()
    cls = ocrd_adapter.BRIDGES['ocrd-cor-asv-ann-process'](
        ocrd_module=ocrd, page_module=ocrd_page)
    proc = cls(parameter=params)
    assert isinstance(proc._inner, ANNCorrection)
    assert proc._inner.s2s.device.type == 'cpu'
    doc = _page_with_line('Der Hvnd liegt')
    line = doc.get_lines()[0]
    for i, token in enumerate(['Der', 'Hvnd', 'liegt']):
        P.add_word(line, 'w%d' % i).add_textequiv(token, conf=0.9)
    xml = doc.to_bytes().decode('utf-8')
    result = proc.process_page_pcgts(StubPage(xml), page_id='p1')
    direct = ANNCorrection(parameter=params).process_page(
        [P.parse_page(xml)], 'p1')
    assert P.parse_page(result.pcgts.xml).to_bytes() == direct.to_bytes()
