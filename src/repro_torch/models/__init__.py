from .cnn import MnistCNN, CifarCNN, param_count
from .config import ArchConfig
from .transformer import CausalLM

__all__ = ["MnistCNN", "CifarCNN", "param_count", "ArchConfig", "CausalLM"]
