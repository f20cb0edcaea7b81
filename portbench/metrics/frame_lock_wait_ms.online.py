"""frame_lock_wait_ms.online: per camera frame (the program's `frame`
span), the milliseconds its thread waited for the estimator's lock held by
the learner (its `lock_wait` spans), averaged over the traced window's
frames; a frame that did not wait adds 0."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_program", pathlib.Path(__file__).with_name("_program.py"))
program = importlib.util.module_from_spec(_s)
_s.loader.exec_module(program)


def read(ctx):
    recs = program.spans(ctx)
    frames = [r for r in recs if r.name == "frame"]
    if not frames:
        return None
    return sum(sum(program.ms(w) for w in program.descendants(recs, f, lambda n: n == "lock_wait"))
               for f in frames) / len(frames)
