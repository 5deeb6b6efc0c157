"""The open loop's schedule on a simulated clock: latency from each frame's
due time, the backlog of a busy reconstructor, the generator's lateness."""

import numpy as np
import pytest

from sfmbench import harness


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class FakeStream:
    """Registers a chunk's frames when it returns; each call takes ``cost``
    seconds of the clock; ``never`` frames never register."""

    def __init__(self, clock, frames, chunk, cost, never=(), late=0.0):
        self.clock, self.frames, self.chunk, self.cost = clock, frames, chunk, cost
        self.never, self.late = set(never), late
        self.valid = np.zeros(frames, bool)
        self.last = {}

    def process(self, c):
        self.clock.t += self.cost[c] if isinstance(self.cost, list) else self.cost
        for f in range(c * self.chunk, (c + 1) * self.chunk):
            self.valid[f] = f not in self.never
        self.last = {"span_s": 0.0, "global_ba": False, "profiled": False}
        return self.valid.copy()

    def finalize(self):
        self.clock.t += self.late
        return self.valid.copy()


def drive(cost, seconds=1.0, rate=10.0, chunk=5, frames=10, never=(), late=0.0):
    clock = Clock()
    out = harness.drive_open(lambda s: FakeStream(clock, frames, chunk, cost, never, late),
                             seconds, rate, chunk, frames, clock=clock, sleep=clock.sleep)
    return out


def test_latency_runs_from_the_due_time():
    out = drive(cost=0.2)
    lat, failed = harness.frame_latencies(out)
    assert failed == 0 and out["streams"] == 1
    # chunk 0: frames due at 0.0-0.4, handed at 0.4, back at 0.6
    assert lat[:5] == pytest.approx([0.6, 0.5, 0.4, 0.3, 0.2])
    # chunk 1: due 0.5-0.9, handed at 0.9 (the reconstructor was free at 0.6)
    assert lat[5:] == pytest.approx([0.6, 0.5, 0.4, 0.3, 0.2])
    assert all(c["backlog"] == pytest.approx(0.0) for c in out["chunks"])


def test_a_busy_reconstructor_builds_a_backlog():
    out = drive(cost=[1.0, 0.1])
    ch = out["chunks"]
    # chunk 1 was due at 0.9 but the reconstructor came back at 1.4
    assert ch[1]["handed"] == pytest.approx(1.4)
    assert ch[1]["backlog"] == pytest.approx(0.5)
    assert ch[1]["late"] == pytest.approx(0.0)
    lat, _ = harness.frame_latencies(out)
    assert lat[9] == pytest.approx(1.5 - 0.9)


def test_streams_follow_one_schedule():
    out = drive(cost=0.1, seconds=2.5)
    assert out["streams"] == harness.open_streams(2.5, 10.0, 10) == 3
    assert len(out["due"]) == 30
    assert out["due"][10] == pytest.approx(1.0) and out["due"][29] == pytest.approx(2.9)


def test_a_frame_never_registered_counts_at_its_streams_end():
    out = drive(cost=0.1, never=(3,), late=0.25)
    lat, failed = harness.frame_latencies(out)
    assert failed == 1
    # the stream ended after finalize: chunk 1 back at 1.0, finalize 0.25 more
    assert lat[3] == pytest.approx(1.25 - 0.3)


def test_the_generators_lateness_is_recorded():
    clock = Clock()

    def late_sleep(s):
        clock.t += s + 0.05          # a sleep that overshoots

    out = harness.drive_open(lambda s: FakeStream(clock, 10, 5, 0.1), 1.0, 10.0, 5, 10,
                             clock=clock, sleep=late_sleep)
    assert [c["late"] for c in out["chunks"]] == pytest.approx([0.05, 0.05])
