from .replay import (
    CameraFrame,
    ReplayReport,
    Sequence,
    StateSample,
    load_sequence,
    run_replay,
    save_sequence,
    synthetic_sequence,
)
from .runtime import InferenceResult, SystemState, WVNRuntime
from .scheduler import Scheduler
