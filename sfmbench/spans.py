"""The program's own spans of a traced run, for the per-layer readers.

While a profiler runs, the port records a span at each layer boundary
(``eacham_tpu_torch.utils.timer``: name, start and end on the profiler's
clock, parent, root, counts). Here they are fetched, cut to the traced
request (the last ``run_sfm``) or the traced stream (the last
reconstructor's ``process`` and ``finalize`` calls), and summed: seconds
and counts.

A program without the recorder, or a run that recorded nothing, gives
None, and the reader that asked returns None.
"""

from __future__ import annotations

from collections import defaultdict


def records():
    """The program's span records, or None where it keeps none."""
    try:
        from eacham_tpu_torch.utils import timer
    except ImportError:
        return None
    fetch = getattr(timer, "records", None)
    recs = fetch() if fetch is not None else None
    return recs or None


class Tree:
    """The closed records of the roots ``roots`` (indices into ``recs``,
    whose ``parent`` indices they keep)."""

    def __init__(self, recs: list[dict], roots: set):
        self.recs = recs
        self.idx = [i for i, r in enumerate(recs)
                    if r["root"] in roots and r["end_ns"] is not None]
        self.children = defaultdict(list)
        for i in self.idx:
            if recs[i]["parent"] is not None:
                self.children[recs[i]["parent"]].append(i)

    def named(self, name: str, under: list[int] | None = None) -> list[int]:
        """The spans called ``name`` (inside the spans ``under``, where given)."""
        pool = self.idx if under is None else [j for i in under for j in self.within(i)]
        return [i for i in pool if self.recs[i]["name"] == name]

    def within(self, i: int) -> list[int]:
        """Span ``i`` and every span inside it."""
        out, todo = [], [i]
        while todo:
            j = todo.pop()
            out.append(j)
            todo.extend(self.children[j])
        return out

    def seconds(self, spans: list[int]) -> float:
        return sum(self.recs[i]["end_ns"] - self.recs[i]["start_ns"] for i in spans) / 1e9

    def count(self, spans: list[int], counter: str, deep: bool = False) -> int:
        """The sum of ``counter`` over ``spans`` (and every span inside
        them, with ``deep``)."""
        pool = [j for i in spans for j in self.within(i)] if deep else spans
        return sum(self.recs[i]["counts"].get(counter, 0) for i in pool)


def batch(ctx) -> Tree | None:
    """The traced request's tree: its ``run_sfm`` (the last one recorded)."""
    if ctx.get("traced_request") is None:
        return None
    recs = records()
    if recs is None:
        return None
    runs = [r["root"] for r in recs
            if r["name"] == "sfm.pipeline.run_sfm" and r["parent"] is None]
    return Tree(recs, {runs[-1]}) if runs else None


def stream(ctx) -> Tree | None:
    """The traced stream's tree: every ``process`` and ``finalize`` call of
    the last reconstructor recorded."""
    if ctx.get("stream") is None:
        return None
    recs = records()
    if recs is None:
        return None
    calls = [r for r in recs if r["parent"] is None
             and r["name"] in ("sfm.streaming.process", "sfm.streaming.finalize")]
    if not calls:
        return None
    tag = calls[-1]["attrs"].get("stream")
    return Tree(recs, {r["root"] for r in calls if r["attrs"].get("stream") == tag})


def share(tree: Tree | None, part: str, whole: str) -> float | None:
    """Percent of the ``whole`` spans' time spent in the ``part`` spans
    inside them."""
    if tree is None:
        return None
    outer = tree.named(whole)
    total = tree.seconds(outer)
    if not outer or total <= 0:
        return None
    return 100.0 * tree.seconds(tree.named(part, under=outer)) / total


def mean_count(tree: Tree | None, name: str, counter: str) -> float | None:
    """Mean ``counter`` over the ``name`` spans that carry it."""
    if tree is None:
        return None
    xs = [tree.recs[i]["counts"][counter] for i in tree.named(name)
          if counter in tree.recs[i]["counts"]]
    return sum(xs) / len(xs) if xs else None
