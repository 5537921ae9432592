from .registry import CNN_ARCHS, get_config, reduced

__all__ = ["CNN_ARCHS", "get_config", "reduced"]
