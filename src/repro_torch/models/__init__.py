from .cnn import MnistCNN, CifarCNN, param_count

__all__ = ["MnistCNN", "CifarCNN", "param_count"]
