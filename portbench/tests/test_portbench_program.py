"""The readers of the program's own spans, on hand-made records: each reads
only spans that start inside the traced interval, a program without the
ring gives None, and the program's "wvn." ranges in a profiler trace take
no operation from the harness's spans."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, trace  # noqa: E402
from portbench.tests.test_portbench_trace import Ev  # noqa: E402
from wild_visual_navigation_tpu_torch.utils import timers  # noqa: E402
from wild_visual_navigation_tpu_torch.utils.timers import SpanRecord  # noqa: E402

MS = 1_000_000


def rec(name, sid, parent, start_ms, end_ms, cpu_ms=None, request=1, thread=1):
    cpu = end_ms - start_ms if cpu_ms is None else cpu_ms
    return SpanRecord(name, request, sid, parent, thread, int(start_ms * MS), int(end_ms * MS), int(cpu * MS))


# two camera frames (requests 1, 2) on thread 1 and one learner tick (request 3) on thread 2, inside [0, 1000] ms;
# one frame outside it
RECORDS = [
    rec("frame", 1, 0, 10, 30), rec("frame.dispatch", 2, 1, 11, 21, cpu_ms=6), rec("frame.insert", 3, 1, 22, 29),
    rec("lock_wait", 4, 3, 22, 26), rec("sync.other", 5, 2, 12, 13)._replace(cpu_ns=-1),
    rec("frame", 11, 0, 110, 125, request=2), rec("frame.dispatch", 12, 11, 111, 119, cpu_ms=7, request=2),
    rec("sync.site", 13, 12, 115, 117, request=2)._replace(cpu_ns=-1), rec("frame.insert", 14, 11, 120, 124, request=2),
    rec("supervision", 21, 0, 40, 46, request=3, thread=2), rec("estimator.reproject", 22, 21, 41, 44, request=3,
                                                                thread=2),
    rec("estimator.train_step", 23, 0, 50, 58, request=3, thread=2),
    rec("sync.supervision_counts", 24, 0, 49, 50, request=3, thread=2),
    rec("sync.loss", 25, 0, 58, 61, request=3, thread=2), rec("hot_swap", 26, 0, 61, 65, request=3, thread=2),
    rec("frame", 31, 0, 2000, 2030, request=4), rec("frame.dispatch", 32, 31, 2001, 2100, cpu_ms=1, request=4),
]


def ctx_for(monkeypatch, records, cameras=1, have_ring=True):
    if have_ring:
        monkeypatch.setattr(timers, "snapshot", lambda: {"spans": list(records), "counters": {}}, raising=False)
    else:
        monkeypatch.delattr(timers, "snapshot")
    tr = trace.reduce([Ev("portbench.learning_step", "CPU", 48 * MS, 20 * MS, tid=2, user=True),
                       Ev("portbench.learning_step", "CPU", 148 * MS, 5 * MS, tid=2, user=True)], 0, 1000 * MS)
    timings = SimpleNamespace(trace_interval=(0, 1000 * MS))
    return SimpleNamespace(timings=timings, trace=tr, cfg={}, mix={"cameras": cameras}, setup_s=1.0)


@pytest.mark.parametrize("name,cameras,expected", [
    ("frame_dispatch_ms.online", 1, 9.0),  # median of 10 and 8 ms; the frame outside the interval left out
    ("frame_dispatch_ms.frames", 4, 9.0 / 4),
    ("frame_lock_wait_ms.online", 1, 2.0),  # 4 ms in the first frame, 0 in the second
    ("frame_offcpu_ms.online", 1, (4.0 + 1.0) / 2),  # wall - CPU of each dispatch, 10 - 6 and 8 - 7
    ("reproject_ms.learn", 4, 3.0),
    ("learn_sync_ms.learn", 4, (1.0 + 3.0) / 2),  # the learner's reads over two ticks; the frame's read left out
    ("hot_swap_ms.learn", 4, 4.0),
])
def test_program_readers_on_hand_made_records(monkeypatch, name, cameras, expected):
    value = harness.load_metric(name).read(ctx_for(monkeypatch, RECORDS, cameras))
    assert value == pytest.approx(expected)
    assert harness.load_metric(name).read(ctx_for(monkeypatch, RECORDS, cameras, have_ring=False)) is None
    assert harness.load_metric(name).read(ctx_for(monkeypatch, [], cameras)) is None


def test_program_ranges_take_no_operations_from_harness_spans():
    """A "wvn." range nests inside a harness span on the launching thread;
    the harness span keeps every operation launched inside it, and the
    device-side annotation counts as no operation."""
    harness_only = [
        Ev("portbench.image_callback", "CPU", 1000, 900, tid=1, user=True),
        Ev("cudaLaunchKernel", "CPU", 1100, 5, corr=7, tid=1),
        Ev("cudaLaunchKernel", "CPU", 1500, 5, corr=8, tid=1),
        Ev("flash_fwd_bf16_kernel", "CUDA", 1150, 100, corr=7),
        Ev("slic_step_kernel", "CUDA", 1550, 100, corr=8),
    ]
    program = [Ev("wvn.frame", "CPU", 1010, 880, tid=1, user=True),
               Ev("wvn.frame.dispatch", "CPU", 1050, 500, tid=1, user=True),
               Ev("wvn.frame.dispatch", "CUDA", 1150, 100, corr=9, user=True)]
    a, b = trace.reduce(harness_only, 1000, 2000), trace.reduce(harness_only + program, 1000, 2000)
    (fa,), (fb,) = a.spans_named("image_callback"), b.spans_named("image_callback")
    assert [b.names[i] for i in fb.ops] == [a.names[i] for i in fa.ops] == ["flash_fwd_bf16_kernel",
                                                                             "slic_step_kernel"]
    assert [s.name for s in b.spans] == ["image_callback"] and b.busy_s() == a.busy_s()
