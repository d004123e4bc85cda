"""Join processor (ocrd-cor-asv-ann-join).

A copy of the JAX package's ``wrapper/join.py`` (host code), kept here so
the port imports nothing of that package.

Re-derivation of reference JoinLines (wrapper/join.py:24-106): concatenate
the TextEquivs of matching TextLines across input fileGrps into one
multi-TextEquiv annotation (optionally tagging each by fileGrp name in
@comments and/or fileGrp index in @index) — the input format for
evaluation with match_on=index.
"""

from .base import PageProcessor, processor_cli
from .evaluate import _linekey


class JoinLines(PageProcessor):
    """Concatenate matching lines' TextEquivs across fileGrps."""

    executable = 'ocrd-cor-asv-ann-join'
    input_file_grp_cardinality = (2, None)
    parameter_schema = {
        'match-on': {'type': 'string', 'default': 'id',
                     'enum': ['id', 'coords', 'baseline']},
        'add-filegrp-comments': {'type': 'boolean', 'default': False},
        'add-filegrp-index': {'type': 'boolean', 'default': False},
    }

    def setup(self):
        # per-page use without the workspace runner (OCR-D core adapter)
        # must not crash on add-filegrp-comments; the adapter seeds real
        # fileGrp names via start_document, this is the bare fallback
        self.input_file_grps = None

    def start_document(self, workspace, input_grps, output_grp):
        self.input_file_grps = input_grps

    def _grp_name(self, i):
        if self.input_file_grps is not None:
            return self.input_file_grps[i]
        return 'input-%d' % i

    def process_page(self, docs, page_id):
        comments = self.parameter['add-filegrp-comments']
        index = self.parameter['add-filegrp-index']
        match = self.parameter['match-on']
        id2line = [{} for _ in docs]
        result = None
        master = 0
        for i, doc in enumerate(docs):
            if doc is None:
                continue
            id2line[i] = {_linekey(line, match, self.logger): line
                          for line in doc.get_lines()}
            if result is None:
                result = doc
                master = i
        if result is None:
            return None
        for line_id, line0 in id2line[master].items():
            gathered = []
            for i, lines in enumerate(id2line):
                line = lines.get(line_id)
                if line is None:
                    continue
                for te in line.get_textequivs():
                    entry = dict(unicode=te.unicode, conf=te.conf,
                                 index=te.index, comments=te.comments)
                    if comments:
                        entry['comments'] = self._grp_name(i)
                    if index:
                        entry['index'] = i
                    gathered.append(entry)
            line0.remove_textequivs()
            for entry in gathered:
                te = line0.add_textequiv(entry['unicode'],
                                         conf=entry['conf'],
                                         index=entry['index'],
                                         comments=entry['comments'])
        return result


ocrd_cor_asv_ann_join = processor_cli(JoinLines)


if __name__ == '__main__':
    ocrd_cor_asv_ann_join()
