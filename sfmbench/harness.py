"""Discovery of a cell's files, the inputs, and the two traffic loops.

Nothing here knows a configuration, a traffic mix, a frontend kind or a
metric by name: ``BENCHMARK.json`` and the configuration name them and the
files are found under this folder (``configs/``, ``traffic/``, ``metrics/``,
``inputs/``, ``frontends/``, ``reference/frontends/``, ``limits/``).
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


class CellError(RuntimeError):
    """A cell that BENCHMARK.json or this folder's files cannot make."""


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing file {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """Import the file ``path`` as a fresh module (file names may hold dots)."""
    if not path.is_file():
        raise CellError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(f"sfmbench_dyn.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, bench_path: Path | None = None, here: Path = HERE) -> dict:
    """Everything one run of ``workload`` needs, read from BENCHMARK.json and
    this folder: the entry, its configuration and traffic files, the
    configuration's frontend kind (``frontends/<kind>.py``, the program's
    side, and ``reference/frontends/<kind>.py``, the judge's; both None for
    a configuration without a frontend), the metrics it reports with their
    readers, and its limits."""
    bench = load_json(bench_path or (here.parent / "BENCHMARK.json"))
    rows = [w for w in bench["workloads"] if w["name"] == workload]
    if not rows:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    w = rows[0]
    conf_rows = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not conf_rows:
        raise CellError(f"no configuration {w['config']!r} in BENCHMARK.json")
    config = load_json(here.parent / conf_rows[0]["file"])
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    frontend, reference = frontend_kind(config, here)
    if traffic["mode"] == "open" and not getattr(frontend, "STREAMS", False):
        raise CellError(f"configuration {w['config']!r}: its frontend does not stream, "
                        f"and traffic {w['traffic']!r} is an open loop")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    layer = [m for m in bench["per_layer"] if applies(m)]
    readers = {m["name"]: load_module(here / "metrics" / f"{m['name']}.py", m["name"])
               for m in e2e + layer}
    limits_path = here / "limits" / f"{workload}.json"
    limits = load_json(limits_path)["limits"] if limits_path.is_file() else None
    if limits is not None:
        limits.update(stated_limits(config))
    return {"workload": w, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": layer, "readers": readers, "limits": limits,
            "run_seconds": bench["run_seconds"], "frontend": frontend,
            "reference": reference}


def frontend_kind(config: dict, here: Path = HERE):
    """The configuration's frontend kind as (the program's module
    ``frontends/<kind>.py``, the reference's ``reference/frontends/<kind>.py``);
    (None, None) where the configuration has no frontend."""
    fe = config.get("frontend")
    if fe is None:
        return None, None
    kind = fe["kind"]
    return (load_module(here / "frontends" / f"{kind}.py", f"frontends.{kind}"),
            load_module(here / "reference" / "frontends" / f"{kind}.py",
                        f"reference.frontends.{kind}"))


def stated_limits(config: dict) -> dict:
    """The limits the configuration states itself (its ``guarantees``)."""
    g = config["guarantees"]
    return {"unregistered": config["inputs"]["frames"] - g["min_registered"],
            "ate": g["max_ate"]}


def check_spec(c: dict) -> dict:
    """What the judge needs of a cell (``cell``'s result): the
    configuration's ``check`` settings, its frontend and the kind's
    reference module, and the candidate pairs the cell states: the stream's
    window and retrievals; in the closed loop, the rule the frontend block
    states (``frontend.pairs``: ``window``, ``retrieval_k``, ``ladder``, the
    arguments of ``sfm.matches.candidate_pairs``, whose retrieval looks to
    both sides of a frame), or else the exhaustive pairs (``pair_window`` 0,
    run_sfm's default)."""
    config, t = c["config"], c["traffic"]
    stated = (config.get("frontend") or {}).get("pairs")
    if t["mode"] == "open":
        pairs = {"window": t["window"], "retrieval_k": t["retrieval_k"]}
    elif stated is not None:
        pairs = {"window": stated["window"], "retrieval_k": stated["retrieval_k"],
                 "ladder": stated["ladder"], "symmetric": True}
    elif config["options"].get("pair_window", 0) == 0:
        pairs = {"window": 0, "retrieval_k": 0}
    else:
        raise CellError("the judge states no candidate pairs for run_sfm's pair_window")
    return dict(config["check"], frontend=config.get("frontend"), reference=c["reference"],
                pairs=pairs)


def make_inputs(config: dict, here: Path = HERE) -> dict:
    """The configuration's inputs from ``inputs/<kind>.py``, made from its
    ``world_seed``."""
    params = dict(config["inputs"])
    kind = params.pop("kind")
    seed = params.pop("world_seed")
    return load_module(here / "inputs" / f"{kind}.py", kind).make(params, seed)


def request_seed(seed: int, k: int) -> int:
    """The RANSAC seed of request ``k`` of a run seeded ``seed``: a 62-bit
    integer from numpy's SeedSequence, so that any run seed (negative, or
    above 32 bits) gives a valid and distinct generator seed."""
    a, b = np.random.SeedSequence([seed & (2 ** 64 - 1), k]).generate_state(2)
    return int((int(a) << 30) ^ int(b))


def sample_seed(seed: int) -> int:
    """The seed of the check's samples of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed & (2 ** 64 - 1), 2 ** 32]).generate_state(1)[0])


# ---- the closed loop: whole requests back to back ---------------------------------

def drive_closed(run_once, seconds: float, need: int = 1, clock=time.perf_counter) -> dict:
    """Run ``run_once(k)`` for k = 0, 1, ... until the window has run at least
    ``seconds`` and ``need`` requests. Each call returns its record (it
    synchronizes the device itself). Returns {"records", "window_s"}: the
    window ends with its last request."""
    t0 = clock()
    records = []
    while True:
        records.append(run_once(len(records)))
        if clock() - t0 >= seconds and len(records) >= need:
            break
    return {"records": records, "window_s": clock() - t0}


# ---- the open loop: frames due at a fixed camera rate ------------------------------

def open_streams(seconds: float, rate: float, stream_frames: int) -> int:
    """How many streams ``drive_open`` starts: those whose first frame is due
    inside the window (at least one)."""
    s = 1
    while s * stream_frames / rate < seconds:
        s += 1
    return s


def drive_open(new_stream, seconds: float, rate: float, chunk: int, stream_frames: int,
               clock=time.perf_counter, sleep=time.sleep) -> dict:
    """Streams of ``stream_frames`` frames back to back on one schedule: frame
    g of the window is due at ``g / rate`` seconds. A chunk is handed over
    when its last frame is due or when the reconstructor is free, whichever
    is later. Streams start while their first frame is due inside
    ``seconds``; each runs to its end.

    ``new_stream(s)`` returns an object with ``process(c) -> valid [M]``
    (hand over chunk c, wait for it, return which of the stream's frames
    have a valid pose) and ``finalize() -> valid [M]``. Returns the due
    time and the first-valid time of every frame (None: never valid), the
    chunks' records and the window's length.
    """
    if stream_frames % chunk:
        raise CellError(f"stream of {stream_frames} frames is not a whole number of "
                        f"{chunk}-frame chunks")
    t0 = clock()
    due = []
    first_valid = []
    chunks = []
    free = t0
    s = 0
    while s < open_streams(seconds, rate, stream_frames):
        base = s * stream_frames
        stream = new_stream(s)
        seen = np.zeros(stream_frames, bool)
        own_due = [t0 + (base + f) / rate for f in range(stream_frames)]
        own_valid = [None] * stream_frames

        def mark(valid, at):
            new = np.asarray(valid, bool) & ~seen
            for f in np.nonzero(new)[0]:
                own_valid[f] = at
            seen[:] |= new

        for c in range(stream_frames // chunk):
            last_due = own_due[(c + 1) * chunk - 1]
            wait = last_due - clock()
            if wait > 0:
                sleep(wait)
            handed = clock()
            valid = stream.process(c)
            back = clock()
            mark(valid, back)
            chunks.append({"stream": s, "chunk": c, "due": last_due - t0,
                           "handed": handed - t0, "returned": back - t0,
                           "late": handed - max(last_due, free),
                           "backlog": max(handed - last_due, 0.0),
                           "seconds": back - handed, **stream.last})
            free = back
        valid = stream.finalize()
        back = clock()
        mark(valid, back)
        free = back
        due.extend(d - t0 for d in own_due)
        first_valid.extend(None if v is None else v - t0 for v in own_valid)
        chunks[-1]["finalize_returned"] = back - t0
        s += 1
    end = clock()
    return {"due": due, "first_valid": first_valid, "chunks": chunks,
            "streams": s, "window_s": end - t0}


def frame_latencies(out: dict) -> tuple[list[float], int]:
    """Per-frame latency from its due time to the return after which its pose
    was first valid; a frame never registered counts as registered when its
    stream ended (its stream's ``finalize`` return). Returns (latencies in
    seconds, frames never registered)."""
    ends = {}
    for c in out["chunks"]:
        if "finalize_returned" in c:
            ends[c["stream"]] = c["finalize_returned"]
    per_stream = len(out["due"]) // max(len(ends), 1)
    lat, failed = [], 0
    for g, (d, v) in enumerate(zip(out["due"], out["first_valid"])):
        if v is None:
            failed += 1
            v = ends[g // per_stream]
        lat.append(v - d)
    return lat, failed
