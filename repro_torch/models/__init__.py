from .cnn import (ALEXNET, VGG16, VGG19, CNNConfig, cnn_forward, cnn_init,
                  cnn_quantize_params, cnn_reduced)

__all__ = ["ALEXNET", "VGG16", "VGG19", "CNNConfig", "cnn_forward",
           "cnn_init", "cnn_quantize_params", "cnn_reduced"]
