"""Minimal PAGE-XML object layer (ElementTree-backed, namespace-tolerant).

A copy of the JAX package's ``utils/page.py`` (host code), kept here so
the port imports nothing of that package.

The OCR-D processor layer of the reference builds on `ocrd_models`'
generated PAGE bindings; this framework carries its own small layer so the
PAGE-XML processors work without the ocrd stack. It supports exactly what
the processors need (reference wrapper/transcode.py, evaluate.py, align.py,
join.py, mark.py):

- parsing/serializing PcGts documents, preserving unknown content,
- region/line/word/glyph traversal in reading order (ReadingOrder groups,
  readingDirection, textLineOrder),
- TextEquiv lists (Unicode, conf, index, dataType/comments) read/write,
- Coords/Baseline points, word merge/split coordinate arithmetic helpers.
"""

import xml.etree.ElementTree as ET

PAGE_NS_PREFIX = 'http://schema.primaresearch.org/PAGE/gts/pagecontent/'
DEFAULT_NS = PAGE_NS_PREFIX + '2019-07-15'


def _local(tag):
    return tag.rsplit('}', 1)[-1] if '}' in tag else tag


def _ns_of(elem):
    if elem.tag.startswith('{'):
        return elem.tag[1:elem.tag.index('}')]
    return ''


class PageElement:
    """Wrapper around an ElementTree element within a PcGts document."""

    def __init__(self, elem, doc, parent=None):
        self.elem = elem
        self.doc = doc
        self.parent = parent

    # -- generic ------------------------------------------------------
    @property
    def tag(self):
        return _local(self.elem.tag)

    @property
    def id(self):
        return self.elem.get('id')

    def attr(self, name, default=None):
        return self.elem.get(name, default)

    def set_attr(self, name, value):
        if value is None:
            self.elem.attrib.pop(name, None)
        else:
            self.elem.set(name, str(value))

    def _q(self, tag):
        return '{%s}%s' % (self.doc.ns, tag) if self.doc.ns else tag

    def children(self, tag):
        return [PageElement(e, self.doc, self)
                for e in self.elem if _local(e.tag) == tag]

    def remove_children(self, tag):
        for e in list(self.elem):
            if _local(e.tag) == tag:
                self.elem.remove(e)

    # -- TextEquiv ----------------------------------------------------
    def get_textequivs(self):
        """All TextEquiv children as dicts with a live element handle."""
        out = []
        for e in self.elem:
            if _local(e.tag) != 'TextEquiv':
                continue
            uni = e.find(self._q('Unicode'))
            te = TextEquiv(e, self.doc,
                           uni.text if uni is not None else None)
            te.parent = self
            out.append(te)
        return out

    def get_text(self, index=None):
        """Unicode of the first TextEquiv (or of the given @index)."""
        for te in self.get_textequivs():
            if index is None or te.index == index:
                return te.unicode
        return None

    def set_text(self, text, conf=None, index=None):
        """Set the first TextEquiv (creating one if absent)."""
        tes = self.get_textequivs()
        if tes:
            te = tes[0]
            te.unicode = text
            if conf is not None:
                te.conf = conf
            if index is not None:
                te.index = index
            return te
        return self.add_textequiv(text, conf=conf, index=index)

    def add_textequiv(self, text, conf=None, index=None, data_type=None,
                      data_type_details=None, comments=None):
        te_el = ET.SubElement(self.elem, self._q('TextEquiv'))
        uni = ET.SubElement(te_el, self._q('Unicode'))
        uni.text = text
        te = TextEquiv(te_el, self.doc, text)
        te.parent = self
        if conf is not None:
            te.conf = conf
        if index is not None:
            te.index = index
        if data_type is not None:
            te_el.set('dataType', data_type)
        if data_type_details is not None:
            te_el.set('dataTypeDetails', data_type_details)
        if comments is not None:
            te_el.set('comments', comments)
        return te

    def remove_textequivs(self):
        self.remove_children('TextEquiv')

    # -- geometry -----------------------------------------------------
    def get_points(self, what='Coords'):
        e = self.elem.find(self._q(what))
        if e is None or not e.get('points'):
            return []
        return [tuple(map(int, map(float, p.split(','))))
                for p in e.get('points').split()]

    def set_points(self, points, what='Coords'):
        e = self.elem.find(self._q(what))
        if e is None:
            e = ET.Element(self._q(what))
            if what == 'Baseline':
                # the PAGE schema sequence puts Baseline AFTER Coords
                coords = self.elem.find(self._q('Coords'))
                pos = (list(self.elem).index(coords) + 1
                       if coords is not None else 0)
                self.elem.insert(pos, e)
            else:
                self.elem.insert(0, e)
        e.set('points', ' '.join('%d,%d' % (x, y) for x, y in points))

    # -- structure ----------------------------------------------------
    def get_words(self):
        return self.children('Word')

    def get_glyphs(self):
        return self.children('Glyph')

    def get_lines(self):
        return self.children('TextLine')

    def index_of(self, child):
        for i, e in enumerate(self.elem):
            if e is child.elem:
                return i
        return -1

    def insert_child(self, pos, elem):
        self.elem.insert(pos, elem)

    def remove_child(self, child):
        self.elem.remove(child.elem)


class TextEquiv:
    def __init__(self, elem, doc, text):
        self.elem = elem
        self.doc = doc
        self.parent = None
        self._text = text

    def _q(self, tag):
        return '{%s}%s' % (self.doc.ns, tag) if self.doc.ns else tag

    @property
    def unicode(self):
        uni = self.elem.find(self._q('Unicode'))
        return uni.text if uni is not None and uni.text is not None else ''

    @unicode.setter
    def unicode(self, text):
        uni = self.elem.find(self._q('Unicode'))
        if uni is None:
            uni = ET.SubElement(self.elem, self._q('Unicode'))
        uni.text = text

    @property
    def conf(self):
        v = self.elem.get('conf')
        return float(v) if v is not None else None

    @conf.setter
    def conf(self, value):
        if value is None:
            # symmetric with the getter (and the comments setter):
            # restoring a captured pre-mark conf of None removes the
            # attribute instead of crashing on float(None)
            self.elem.attrib.pop('conf', None)
        else:
            self.elem.set('conf', '%.6g' % float(value))

    @property
    def index(self):
        v = self.elem.get('index')
        return int(v) if v is not None else None

    @index.setter
    def index(self, value):
        self.elem.set('index', str(int(value)))

    @property
    def comments(self):
        return self.elem.get('comments')

    @comments.setter
    def comments(self, value):
        if value is None:
            self.elem.attrib.pop('comments', None)
        else:
            self.elem.set('comments', value)

    @property
    def data_type(self):
        return self.elem.get('dataType')


class PageDoc:
    """A parsed PcGts document."""

    def __init__(self, tree):
        self.tree = tree
        self.root = tree.getroot()
        self.ns = _ns_of(self.root)
        if self.ns:
            ET.register_namespace('', self.ns)

    def _q(self, tag):
        return '{%s}%s' % (self.ns, tag) if self.ns else tag

    @property
    def page(self):
        for e in self.root:
            if _local(e.tag) == 'Page':
                return PageElement(e, self, None)
        raise ValueError('document has no Page element')

    # -- traversal in reading order -----------------------------------
    def get_regions(self, order=True):
        """Top-level text regions, honoring ReadingOrder groups when
        present (recursively, reference transcode.py:630-742)."""
        page = self.page
        regions = self._collect_regions(page.elem, page)
        if not order:
            return regions
        ro = None
        for e in page.elem:
            if _local(e.tag) == 'ReadingOrder':
                ro = e
                break
        if ro is None:
            return regions
        ordered_ids = []
        def walk(group):
            entries = []
            for e in group:
                tag = _local(e.tag)
                if tag in ('RegionRefIndexed', 'OrderedGroupIndexed',
                           'UnorderedGroupIndexed'):
                    entries.append((int(e.get('index', 0)), e))
                elif tag in ('RegionRef', 'OrderedGroup', 'UnorderedGroup'):
                    entries.append((len(entries), e))
            for _, e in sorted(entries, key=lambda p: p[0]):
                tag = _local(e.tag)
                if tag.startswith('RegionRef'):
                    ordered_ids.append(e.get('regionRef'))
                else:
                    if e.get('regionRef'):
                        ordered_ids.append(e.get('regionRef'))
                    walk(e)
        walk(ro)
        by_id = {r.id: r for r in regions}
        out = [by_id[i] for i in ordered_ids if i in by_id]
        out += [r for r in regions if r.id not in set(ordered_ids)]
        return out

    def reading_order_map(self):
        """{regionRef: (ro_element_tag, index)} over all ReadingOrder
        groups, recursively (reference transcode.py:
        page_get_reading_order). `index` falls back to the position
        inside the group for unindexed entries."""
        out = {}
        page = self.page
        ro = None
        for e in page.elem:
            if _local(e.tag) == 'ReadingOrder':
                ro = e
                break
        if ro is None:
            return out

        def walk(group):
            for pos, e in enumerate(group):
                tag = _local(e.tag)
                if tag not in ('RegionRef', 'RegionRefIndexed',
                               'OrderedGroup', 'OrderedGroupIndexed',
                               'UnorderedGroup', 'UnorderedGroupIndexed'):
                    continue
                ref = e.get('regionRef')
                idx = e.get('index')
                idx = int(idx) if idx is not None else pos
                if ref:
                    out[ref] = (tag, idx)
                if not tag.startswith('RegionRef'):
                    walk(e)
        walk(ro)
        return out

    def _collect_regions(self, elem, parent):
        out = []
        for e in elem:
            if _local(e.tag) == 'TextRegion':
                region = PageElement(e, self, parent)
                out.append(region)
                # nested regions flattened after their parent
                out.extend(self._collect_regions(e, region))
        return out

    def get_lines(self):
        """All text lines of all regions, in reading order; honors
        textLineOrder=bottom-to-top (reference transcode.py:687-705)."""
        lines = []
        for region in self.get_regions():
            rlines = region.get_lines()
            order = region.attr('textLineOrder') or \
                self.page.attr('textLineOrder') or 'top-to-bottom'
            if order == 'bottom-to-top':
                rlines = list(reversed(rlines))
            lines.extend(rlines)
        return lines

    def to_bytes(self):
        import io
        buf = io.BytesIO()
        self.tree.write(buf, encoding='utf-8', xml_declaration=True)
        return buf.getvalue()

    def save(self, path):
        self.tree.write(path, encoding='utf-8', xml_declaration=True)


def parse_page(source):
    """Parse PAGE-XML from a path or bytes/str content."""
    if isinstance(source, bytes):
        import io
        tree = ET.parse(io.BytesIO(source))
    elif isinstance(source, str) and source.lstrip().startswith('<'):
        import io
        tree = ET.parse(io.StringIO(source))
    else:
        tree = ET.parse(source)
    return PageDoc(tree)


def new_page(width=1000, height=1000, image_filename='image.png',
             ns=DEFAULT_NS):
    """Create an empty PcGts document (mainly for tests)."""
    ET.register_namespace('', ns)
    root = ET.Element('{%s}PcGts' % ns)
    metadata = ET.SubElement(root, '{%s}Metadata' % ns)
    ET.SubElement(metadata, '{%s}Creator' % ns).text = 'cor_asv_ann_tpu'
    page = ET.SubElement(root, '{%s}Page' % ns)
    page.set('imageFilename', image_filename)
    page.set('imageWidth', str(width))
    page.set('imageHeight', str(height))
    return PageDoc(ET.ElementTree(root))


def add_region(doc, region_id, points=None):
    ns = doc.ns
    e = ET.SubElement(doc.page.elem, '{%s}TextRegion' % ns if ns
                      else 'TextRegion')
    e.set('id', region_id)
    region = PageElement(e, doc, doc.page)
    if points:
        region.set_points(points)
    return region


def add_line(region, line_id, points=None, baseline=None):
    doc = region.doc
    ns = doc.ns
    e = ET.SubElement(region.elem, '{%s}TextLine' % ns if ns else 'TextLine')
    e.set('id', line_id)
    line = PageElement(e, doc, region)
    if points:
        line.set_points(points)
    if baseline:
        line.set_points(baseline, what='Baseline')
    return line


def add_word(line, word_id, points=None):
    doc = line.doc
    ns = doc.ns
    e = ET.SubElement(line.elem, '{%s}Word' % ns if ns else 'Word')
    e.set('id', word_id)
    word = PageElement(e, doc, line)
    if points:
        word.set_points(points)
    return word


def add_glyph(word, glyph_id, points=None):
    doc = word.doc
    ns = doc.ns
    e = ET.SubElement(word.elem, '{%s}Glyph' % ns if ns else 'Glyph')
    e.set('id', glyph_id)
    glyph = PageElement(e, doc, word)
    if points:
        glyph.set_points(points)
    return glyph


def points_bbox(points):
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    return min(xs), min(ys), max(xs), max(ys)


def bbox_points(x0, y0, x1, y1):
    return [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
