"""learn_sync_ms.learn: the milliseconds per learner tick that the learner
spent in blocking device-to-host reads (the program's `sync.*` spans outside
camera frames: the supervision counts and the loss readback), summed over
the traced window and divided by its learning_step calls."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_program", pathlib.Path(__file__).with_name("_program.py"))
program = importlib.util.module_from_spec(_s)
_s.loader.exec_module(program)


def read(ctx):
    recs = program.spans(ctx)
    ticks = ctx.trace.spans_named("learning_step") if recs else []
    if not ticks:
        return None
    syncs = [r for r in recs if r.name.startswith("sync.") and not program.inside_frame(recs, r)]
    return sum(program.ms(r) for r in syncs) / len(ticks)
