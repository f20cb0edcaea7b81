from .carrot_follower import FollowerConfig, follow_carrot
from .postprocess_logger import MissionLogger
