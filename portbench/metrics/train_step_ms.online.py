"""train_step_ms.online: train_step_ms.learn in the online cell, where the learner's
thread contends with the camera's frames, so it moves frames_per_s there."""
import importlib.util
import pathlib

_s = importlib.util.spec_from_file_location(
    "portbench_metric_train_step_ms_learn", pathlib.Path(__file__).with_name("train_step_ms.learn.py"))
_base = importlib.util.module_from_spec(_s)
_s.loader.exec_module(_base)
read = _base.read
