from .ops import kom_matmul_int, kom_matmul_int_plain

__all__ = ["kom_matmul_int", "kom_matmul_int_plain"]
