"""The trace reduction on hand-made profiler events: each device operation
goes to the harness span of the thread that launched it, the busy time is
the union of the operations' intervals, and the idle time is labelled by
what the host was doing."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import trace  # noqa: E402


class Ev:
    def __init__(self, name, device, start, dur, corr=0, tid=1, user=False):
        self._n, self._d, self._s, self._u, self._c, self._t, self._user = name, device, start, dur, corr, tid, user

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._user


def test_reduce_attributes_and_unions():
    ev = [
        Ev("portbench.image_callback", "CPU", 1000, 500, tid=1, user=True),
        Ev("portbench.learning_step", "CPU", 1200, 600, tid=2, user=True),
        Ev("cudaLaunchKernel", "CPU", 1100, 5, corr=7, tid=1),
        Ev("cudaLaunchKernel", "CPU", 1300, 5, corr=8, tid=2),
        Ev("flash_fwd_bf16_kernel", "CUDA", 1150, 100, corr=7),
        Ev("reduce_kernel", "CUDA", 1200, 100, corr=8),
        Ev("portbench.image_callback", "CUDA", 1150, 100, corr=9, user=True),
    ]
    tr = trace.reduce(ev, 1000, 2000)
    assert tr.window_s == 1000 / 1e9
    (frame,) = tr.spans_named("image_callback")
    (tick,) = tr.spans_named("learning_step")
    assert [tr.names[i] for i in frame.ops] == ["flash_fwd_bf16_kernel"]
    assert [tr.names[i] for i in tick.ops] == ["reduce_kernel"]
    assert tr.busy_s() == 150 / 1e9
    assert tr.op_ms(frame.ops, ("flash_",)) == [100 / 1e6]
    bd = trace.breakdown(tr)
    assert dict(bd["device_ops"]) == {"flash_fwd_bf16_kernel": 100 / 1e9, "reduce_kernel": 100 / 1e9}
    assert abs(sum(v for _, v in bd["idle_gaps"]) - 850 / 1e9) < 1e-15
