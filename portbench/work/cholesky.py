"""Work of one Cholesky factorization of an n x n SPD matrix, at the
logical order n that the caller factors: n^3/3 operations, and the input
read and the factor written once."""


def flops(n: int) -> float:
    return n ** 3 / 3.0


def bytes_moved(n: int, itemsize: int) -> float:
    return 2.0 * n * n * itemsize
