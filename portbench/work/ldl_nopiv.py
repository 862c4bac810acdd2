"""Work of one no-pivot LDL^T of a symmetric n x n matrix, at the logical
order n of the matrix that the caller factors (not the order the wrapper
pads it to): n^3/3 multiply-adds' worth of operations, and the input read
and the factor written once."""


def flops(n: int) -> float:
    return n ** 3 / 3.0


def bytes_moved(n: int, itemsize: int) -> float:
    return 2.0 * n * n * itemsize
