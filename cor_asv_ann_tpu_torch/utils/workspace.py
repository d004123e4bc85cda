"""Minimal METS workspace layer for the PAGE-XML processors.

A copy of the JAX package's ``utils/workspace.py`` (host code), kept here so
the port imports nothing of that package.

Replaces the OCR-D core `Workspace`/METS handling the reference processors
rely on (they run via `ocrd.Processor` over a mets.xml workspace;
reference wrapper/*.py, tests/conftest.py:21-52) with a small standalone
implementation: enumerate fileGrps and page files, read PAGE-XML, add
output files, and keep mets.xml consistent.

Also supports a directory-of-PAGE-XML-files mode (no mets.xml): input
"fileGrp" = subdirectory name, page id = file stem — so users can process
bare PAGE-XML trees without building a METS file first.
"""

import os
import xml.etree.ElementTree as ET

METS_NS = 'http://www.loc.gov/METS/'
XLINK_NS = 'http://www.w3.org/1999/xlink'


def _q(tag, ns=METS_NS):
    return '{%s}%s' % (ns, tag)


class WorkspaceFile:
    def __init__(self, file_id, grp, page_id, path, mimetype):
        self.id = file_id
        self.group = grp
        self.page_id = page_id
        self.path = path
        self.mimetype = mimetype


def index_page_files(files):
    """Filter a file list down to PAGE-XML files, keyed by page id
    (shared by Workspace and the METS-server client facade so the two
    paths cannot diverge). Files without a resolvable path, and files
    that are neither page-mimetyped nor .xml (e.g. images), are
    skipped."""
    out = {}
    for f in files:
        if not f.path:
            continue
        is_page = 'page' in f.mimetype if f.mimetype else False
        if not is_page and not f.path.endswith('.xml'):
            continue
        out[f.page_id] = f
    return out


class Workspace:
    """A METS-backed (or bare-directory) workspace of page files."""

    def __init__(self, directory):
        self.directory = os.path.abspath(directory)
        self.mets_path = os.path.join(self.directory, 'mets.xml')
        self.mets = None
        if os.path.exists(self.mets_path):
            ET.register_namespace('mets', METS_NS)
            ET.register_namespace('xlink', XLINK_NS)
            self.mets = ET.parse(self.mets_path)

    # -- reading ------------------------------------------------------
    def file_groups(self):
        if self.mets is None:
            return sorted(
                d for d in os.listdir(self.directory)
                if os.path.isdir(os.path.join(self.directory, d)))
        return [g.get('USE') for g in
                self.mets.getroot().iter(_q('fileGrp'))]

    def _page_map(self):
        """FILEID -> page div ID over the whole structMap (one pass;
        per-file scans would be O(files x pages) on large workspaces)."""
        pages = {}
        for div in self.mets.getroot().iter(_q('div')):
            if div.get('TYPE') == 'page':
                pid = div.get('ID')
                for fptr in div.findall(_q('fptr')):
                    pages[fptr.get('FILEID')] = pid
        return pages

    def files(self, group=None, page_id=None, mimetype=None):
        """All files, optionally filtered by fileGrp / page / mimetype."""
        out = []
        if self.mets is None:
            groups = [group] if group else self.file_groups()
            for grp in groups:
                gdir = os.path.join(self.directory, grp)
                if not os.path.isdir(gdir):
                    continue
                for name in sorted(os.listdir(gdir)):
                    if not name.endswith('.xml'):
                        continue
                    stem = os.path.splitext(name)[0]
                    if page_id and stem != page_id:
                        continue
                    out.append(WorkspaceFile(
                        '%s_%s' % (grp, stem), grp, stem,
                        os.path.join(gdir, name), 'application/vnd.prima.page+xml'))
            return out
        pages = self._page_map()
        for grp_el in self.mets.getroot().iter(_q('fileGrp')):
            use = grp_el.get('USE')
            if group and use != group:
                continue
            for f in grp_el.findall(_q('file')):
                fid = f.get('ID')
                mt = f.get('MIMETYPE')
                if mimetype and mt != mimetype:
                    continue
                flocat = f.find(_q('FLocat'))
                href = flocat.get(_q('href', XLINK_NS)) if flocat is not None \
                    else None
                pid = pages.get(fid)
                if page_id and pid != page_id:
                    continue
                path = os.path.join(self.directory, href) if href else None
                out.append(WorkspaceFile(fid, use, pid, path, mt))
        return out

    def page_ids(self):
        if self.mets is None:
            ids = []
            for grp in self.file_groups():
                for f in self.files(group=grp):
                    if f.page_id not in ids:
                        ids.append(f.page_id)
            return ids
        ids = []
        for div in self.mets.getroot().iter(_q('div')):
            if div.get('TYPE') == 'page':
                ids.append(div.get('ID'))
        return ids

    def page_files(self, group):
        """PAGE-XML files of a fileGrp keyed by page id."""
        return index_page_files(self.files(group=group))

    # -- writing ------------------------------------------------------
    def add_file(self, group, page_id, content, file_id=None,
                 mimetype='application/vnd.prima.page+xml', ext='.xml'):
        """Write a new file into the workspace and register it."""
        gdir = os.path.join(self.directory, group)
        os.makedirs(gdir, exist_ok=True)
        file_id = file_id or '%s_%s' % (group, page_id)
        # bare-directory mode derives page ids from file stems on read,
        # so page files must be named by page id for ids to round-trip
        # into chained fileGrps (document-level files keep the file_id)
        if self.mets is None and page_id:
            name = page_id + ext
        else:
            name = file_id + ext
        path = os.path.join(gdir, name)
        mode = 'wb' if isinstance(content, bytes) else 'w'
        with open(path, mode) as f:
            f.write(content)
        if self.mets is not None:
            root = self.mets.getroot()
            filesec = root.find(_q('fileSec'))
            if filesec is None:
                filesec = ET.SubElement(root, _q('fileSec'))
            grp_el = None
            for g in filesec.findall(_q('fileGrp')):
                if g.get('USE') == group:
                    grp_el = g
                    break
            if grp_el is None:
                grp_el = ET.SubElement(filesec, _q('fileGrp'))
                grp_el.set('USE', group)
            for f_el in list(grp_el.findall(_q('file'))):
                if f_el.get('ID') == file_id:
                    grp_el.remove(f_el)
            f_el = ET.SubElement(grp_el, _q('file'))
            f_el.set('ID', file_id)
            f_el.set('MIMETYPE', mimetype)
            flocat = ET.SubElement(f_el, _q('FLocat'))
            flocat.set(_q('href', XLINK_NS), os.path.join(group, name))
            flocat.set('LOCTYPE', 'OTHER')
            # register in the page structMap
            for div in root.iter(_q('div')):
                if div.get('TYPE') == 'page' and div.get('ID') == page_id:
                    for fptr in list(div.findall(_q('fptr'))):
                        if fptr.get('FILEID') == file_id:
                            div.remove(fptr)
                    fptr = ET.SubElement(div, _q('fptr'))
                    fptr.set('FILEID', file_id)
                    break
        return path

    def save(self):
        if self.mets is not None:
            self.mets.write(self.mets_path, encoding='utf-8',
                            xml_declaration=True)


def make_workspace(directory, page_ids):
    """Create a fresh METS workspace (mainly for tests)."""
    os.makedirs(directory, exist_ok=True)
    ET.register_namespace('mets', METS_NS)
    ET.register_namespace('xlink', XLINK_NS)
    root = ET.Element(_q('mets'))
    ET.SubElement(root, _q('fileSec'))
    structmap = ET.SubElement(root, _q('structMap'))
    structmap.set('TYPE', 'PHYSICAL')
    top = ET.SubElement(structmap, _q('div'))
    top.set('TYPE', 'physSequence')
    for pid in page_ids:
        div = ET.SubElement(top, _q('div'))
        div.set('TYPE', 'page')
        div.set('ID', pid)
    tree = ET.ElementTree(root)
    tree.write(os.path.join(directory, 'mets.xml'), encoding='utf-8',
               xml_declaration=True)
    return Workspace(directory)
