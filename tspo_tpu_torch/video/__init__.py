from .reader import load_video_indices, video_info

__all__ = ["load_video_indices", "video_info"]
