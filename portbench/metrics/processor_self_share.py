"""processor_self_share.page: the share of the pages' time that
``ANNCorrection.process_page`` spends outside its call to
``correct_lines`` (PAGE to confusion network, realignment,
re-segmenting), from the spans of the untraced pages of the window."""


def read(ctx):
    pages = [s for s in ctx.spans.of('process_page') if not s['traced']]
    if not pages:
        return None
    lo, hi = pages[0]['t0'], pages[-1]['t1']
    inner = sum(s['t1'] - s['t0'] for s in ctx.spans.of('correct_lines')
                if lo <= s['t0'] and s['t1'] <= hi)
    total = sum(s['t1'] - s['t0'] for s in pages)
    return (total - inner) / total
