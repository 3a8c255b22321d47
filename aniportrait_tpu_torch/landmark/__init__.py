from .pipeline import FaceLandmarkerLite

__all__ = ["FaceLandmarkerLite"]
