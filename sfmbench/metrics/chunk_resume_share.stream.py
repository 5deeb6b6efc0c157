"""Share (%) of the traced stream's ``process()`` calls without a global BA
(no ``sfm.pipeline._finalize`` inside) spent in ``resume_sfm``
(``sfm.streaming.process.resume``: the sweep over the chunk's frames)."""

from sfmbench import spans


def read(ctx):
    tree = spans.stream(ctx)
    if tree is None:
        return None
    plain = [i for i in tree.named("sfm.streaming.process")
             if not tree.named("sfm.pipeline._finalize", under=[i])]
    total = tree.seconds(plain)
    if total <= 0:
        return None
    return 100.0 * tree.seconds(tree.named("sfm.streaming.process.resume", under=plain)) / total
