"""Share (%) of the traced request's LM iterations, in its local BAs (the
program's spans ``sfm.device_loop.local_ba``) and its global BAs
(``ba.global``), that ran by replaying a captured CUDA graph: their count
``lm_graph_replays`` over their count ``iterations``. A key's first
iteration runs eagerly and its second captures (the count
``lm_graph_captures``); neither is a replay. A program that counts neither,
as one without the iteration's graph, gives nothing."""

from sfmbench import spans

BAS = ("sfm.device_loop.local_ba", "ba.global")


def read(ctx):
    tree = spans.batch(ctx)
    if tree is None:
        return None
    bas = [i for name in BAS for i in tree.named(name)]
    replays = tree.count(bas, "lm_graph_replays")
    iterations = tree.count(bas, "iterations")
    if not iterations or not (replays or tree.count(bas, "lm_graph_captures")):
        return None
    return 100.0 * replays / iterations
