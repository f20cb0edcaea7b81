"""hot_swap_ms.learn: the median host duration of the program's `hot_swap`
span (the learner's snapshot under the estimator's lock, the new head's
deep copy and load, the publish), ms; one learner tick in ten swaps."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_program", pathlib.Path(__file__).with_name("_program.py"))
program = importlib.util.module_from_spec(_s)
_s.loader.exec_module(program)


def read(ctx):
    return program.median_ms(program.spans(ctx), "hot_swap")
