"""Host waits for the card in the profiled request's deep front half: the
program's count ``readbacks`` summed over the last ``features.deep.extract``
and the last ``sfm.matches.deep`` span recorded and every span inside them
(uploads from pageable memory and reads of device values, counted where
they are made: the extraction's blur taps, the frame similarity, the pair
list, the matcher's size constant, and the epipolar verification's status
reads and upload). None where either span is missing."""

from sfmbench import spans

ROOTS = ("features.deep.extract", "sfm.matches.deep")


def read(ctx):
    if ctx.get("traced_request") is None:
        return None
    recs = spans.records()
    if recs is None:
        return None
    total = 0
    for name in ROOTS:
        roots = [r["root"] for r in recs if r["name"] == name and r["parent"] is None]
        if not roots:
            return None
        tree = spans.Tree(recs, {roots[-1]})
        total += tree.count(tree.named(name), "readbacks", deep=True)
    return float(total)
