"""k4_roofline.online: k4_roofline.learn in the online cell, where the flush
runs on the learner's thread beside the camera's frames, so it moves
frames_per_s there."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location(
    "portbench_metric_k4_roofline_learn", pathlib.Path(__file__).with_name("k4_roofline.learn.py"))
_base = importlib.util.module_from_spec(_s)
_s.loader.exec_module(_base)
read = _base.read
