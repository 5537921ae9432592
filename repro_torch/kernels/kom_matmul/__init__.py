from .ops import (bf16x3_matmul, bf16x3_matmul_plain, kom_matmul_int,
                  kom_matmul_int_plain, kom_split_k)

__all__ = ["bf16x3_matmul", "bf16x3_matmul_plain", "kom_matmul_int",
           "kom_matmul_int_plain", "kom_split_k"]
