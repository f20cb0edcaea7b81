from .visualizer import LearningVisualizer, colormap_rdylbu
from .markers import TriangleList, build_footprint_ribbon, build_graph_path, export_supervision_markers
