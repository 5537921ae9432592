from .ops import (conv2d_implicit, conv2d_systolic, conv2d_winograd,
                  handoff_quantize)

__all__ = ["conv2d_implicit", "conv2d_systolic", "conv2d_winograd",
           "handoff_quantize"]
