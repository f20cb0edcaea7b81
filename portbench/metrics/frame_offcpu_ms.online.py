"""frame_offcpu_ms.online: per camera frame, the milliseconds the camera's
thread spent inside `frame.dispatch` without running: the span's wall time
minus the thread's CPU time in it. Runnable but not running is waiting for
the interpreter lock, held by the learner's thread, or for a core. The
blocking device copies inside the dispatch (the `sync.*` spans) wait for
the card by spinning on the CPU, so they add no off-CPU time and need no
term of their own. The thread's CPU clock ticks in 10-ms steps on the
hosts it was read on, so one frame's reading is off by up to 10 ms either
way; the mean over the traced window's frames is what is read."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_program", pathlib.Path(__file__).with_name("_program.py"))
program = importlib.util.module_from_spec(_s)
_s.loader.exec_module(program)


def read(ctx):
    out = [(r.end_ns - r.start_ns - r.cpu_ns) / 1e6 for r in program.spans(ctx)
           if r.name == "frame.dispatch" and r.cpu_ns >= 0]
    return sum(out) / len(out) if out else None
