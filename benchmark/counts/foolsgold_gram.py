"""FoolsGold's pairwise cosines over x[n, d]: one full n × n Gram matrix
of the normalised rows, multiply and add counted as 2; bytes: x read
once and the n × n matrix written once, float32."""


def flops(n: int, d: int) -> int:
    return 2 * n * n * d


def bytes_moved(n: int, d: int) -> int:
    return (n * d + n * n) * 4
