from .registry import ARCHS, CNN_ARCHS, get_config, list_configs, reduced

__all__ = ["ARCHS", "CNN_ARCHS", "get_config", "list_configs", "reduced"]
