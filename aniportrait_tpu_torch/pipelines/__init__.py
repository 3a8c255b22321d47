from .pose2vid import Pose2ImagePipeline, Pose2VideoPipeline

__all__ = ["Pose2ImagePipeline", "Pose2VideoPipeline"]
