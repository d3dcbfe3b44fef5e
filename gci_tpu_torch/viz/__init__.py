from .plot import plot_depth_files, sliding_window_average

__all__ = ["plot_depth_files", "sliding_window_average"]
