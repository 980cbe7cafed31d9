from .config import EasyConfig
from .registry import Registry

__all__ = ["EasyConfig", "Registry"]
