"""Kernel B1's work for Krum scores of x[n, d]: the Gram matrix's upper
triangle, n(n + 1)/2 dot products of length d, multiply and add counted
as 2; bytes: x read once, the n scores written once, float32."""


def flops(n: int, d: int) -> int:
    return n * (n + 1) * d


def bytes_moved(n: int, d: int) -> int:
    return (n * d + n) * 4
