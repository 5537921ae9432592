from .ops import conv2d_implicit, conv2d_winograd

__all__ = ["conv2d_implicit", "conv2d_winograd"]
