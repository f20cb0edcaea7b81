"""kmeans_ms.stego: the median host duration of the program's `frame.segment`
span in the STEGO frame (cosine k-means over the frame's codes and the
nearest upsample of its labels), ms, over the traced window. A program
whose STEGO frame records no such span reads None."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location("portbench_metrics_program", pathlib.Path(__file__).with_name("_program.py"))
program = importlib.util.module_from_spec(_s)
_s.loader.exec_module(program)


def read(ctx):
    return program.median_ms(program.spans(ctx), "frame.segment")
