"""reproject_ms.learn: the median host duration of the program's
`estimator.reproject` span (one supervision flush: the footprint projected
into the fan-out's frames, K4, the segment means and the buffer writes),
ms; flush_ms.learn times the whole robot_state_callback around it."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_program", pathlib.Path(__file__).with_name("_program.py"))
program = importlib.util.module_from_spec(_s)
_s.loader.exec_module(program)


def read(ctx):
    return program.median_ms(program.spans(ctx), "estimator.reproject")
