from .precision import MatmulPolicy, policy_dot_general, policy_linear
from .substrate import (QTensor, QWeight, conv2d, kom_qmax,
                        prequant_dot_general, quantize_symmetric,
                        quantize_weight)

__all__ = ["MatmulPolicy", "QTensor", "QWeight", "conv2d", "kom_qmax",
           "policy_dot_general", "policy_linear", "prequant_dot_general",
           "quantize_symmetric", "quantize_weight"]
