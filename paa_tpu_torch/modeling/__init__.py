from .detector import DetectionModel, build_detection_model

__all__ = ["DetectionModel", "build_detection_model"]
