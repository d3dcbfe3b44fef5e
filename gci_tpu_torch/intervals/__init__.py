from .collapse import collapse_depth, collapse_depth_runs, collapse_depth_dict
from .merge import distance_merge, distance_merge_dict, complement_intervals, complement_dict

__all__ = [
    "collapse_depth",
    "collapse_depth_runs",
    "collapse_depth_dict",
    "distance_merge",
    "distance_merge_dict",
    "complement_intervals",
    "complement_dict",
]
