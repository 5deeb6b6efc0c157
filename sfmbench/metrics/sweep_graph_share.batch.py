"""Share (%) of the traced request's graphed registration stages (the
program's spans ``sfm.device_loop.pnp`` and ``sfm.device_loop.triangulate``)
that ran by replaying a captured CUDA graph: their count ``graph_replays``
over the number of such spans. A stage's first use with a shape runs
eagerly and its second captures (the count ``graph_captures``); neither is
a replay. A program that counts neither, as one without the stage graphs,
gives nothing."""

from sfmbench import spans

STAGES = ("sfm.device_loop.pnp", "sfm.device_loop.triangulate")


def read(ctx):
    tree = spans.batch(ctx)
    if tree is None:
        return None
    stages = [i for name in STAGES for i in tree.named(name)]
    replays = tree.count(stages, "graph_replays")
    if not stages or not (replays or tree.count(stages, "graph_captures")):
        return None
    return 100.0 * replays / len(stages)
