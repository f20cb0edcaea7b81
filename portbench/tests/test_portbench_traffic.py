"""The traffic is deterministic by seed; the seed changes the content, not
the sizes or the arrivals."""

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.traffic import Traffic  # noqa: E402


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
