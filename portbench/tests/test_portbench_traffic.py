"""The traffic is deterministic by seed; the seed changes the content, not
the sizes or the arrivals."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.system import Caller  # noqa: E402
from portbench.traffic import GRIND, SPEED, Traffic  # noqa: E402


def mix(name):
    return json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())


def test_same_seed_same_events():
    for name, size in (("online", 32), ("batch", 28)):
        a, b = Traffic(mix(name), size, 2**31 + 77, 120), Traffic(mix(name), size, 2**31 + 77, 120)
        for i in (0, 7, 119):
            ea, eb = a.event(i), b.event(i)
            assert all(np.array_equal(x, y) for x, y in zip(ea.images, eb.images))
            assert np.array_equal(ea.current_twist, eb.current_twist) and ea.stamp == eb.stamp
        assert np.array_equal(a.batch(5), b.batch(5))


def test_other_seed_other_content_same_arrivals():
    a, b = Traffic(mix("online"), 32, 3, 200), Traffic(mix("online"), 32, 2**33 + 5, 200)
    assert not np.array_equal(a.event(10).images[0], b.event(10).images[0])
    assert np.array_equal(a.xs, b.xs)
    assert [a.event(i).stamp for i in range(200)] == [b.event(i).stamp for i in range(200)]


def test_gates_pass_every_event():
    t = Traffic(mix("online"), 32, 1, 400)
    stamps = np.array([t.event(i).stamp for i in range(400)])
    assert (np.diff(stamps) >= 0.1).all()
    # the robot grinds through the obstacle bands: it spends longer per metre there
    assert np.diff(t.xs).min() < 0.02 < np.diff(t.xs).max()


def test_frames_budget_keeps_what_the_old_one_held():
    """The frames mix's budget of 1000 calls/s in place of 250: the events,
    their frames and the calls sampled for the check below the old budget's
    12,854 events are the same, and the track is the one stepped through
    the obstacle test."""
    new = mix("frames")
    old = {**new, "max_rate_hz": 250.0}
    n_old, n_new = (int(m["preroll_max_events"]) + int(51 * m["max_rate_hz"]) + 64 for m in (old, new))
    assert (n_old, n_new) == (12_854, 51_104)
    seed = 2**31 + 9
    a, b = Traffic(old, 32, seed, n_old), Traffic(new, 32, seed, n_new)
    assert np.array_equal(a.xs, b.xs[:n_old]) and np.array_equal(a.noise, b.noise[:n_old])
    for i in (0, 99, 100, 7_001, n_old - 1):
        ea, eb = a.event(i), b.event(i)
        assert ea.stamp == eb.stamp and np.array_equal(ea.pose_base, eb.pose_base)
        assert np.array_equal(ea.images[0], eb.images[0]) and np.array_equal(ea.current_twist, eb.current_twist)
    x, xs = 0.0, []
    for _ in range(n_old):
        xs.append(x)
        for _ in range(4):
            x += (GRIND if a.world.in_obstacle(x) else SPEED) * (a.period / 4)
    assert np.array_equal(a.xs, xs)

    def sampled(m):
        rng = np.random.RandomState(np.random.SeedSequence([seed, 23]).generate_state(1)[0])
        return Caller._samples(SimpleNamespace(mix=m), rng, 51.0, "sample_frames").times

    assert sampled(old) == sampled(new) and len(sampled(new)) == new["sample_frames"]
