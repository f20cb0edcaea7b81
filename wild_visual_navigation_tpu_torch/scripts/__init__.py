from .postprocess_logger import MissionLogger
from .smart_carrot import CarrotConfig, select_carrot
from .carrot_follower import FollowerConfig, follow_carrot
