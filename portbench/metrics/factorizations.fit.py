"""Cholesky factorizations per fit (the library's ``cholesky_ex``, which
every likelihood evaluation and the final model run), counted in the
window traced with the host's operations: the work the fit's recipe asks
of the linear algebra."""

from portbench.kernels import host_ops_per_unit

HOST_OPS = ("aten::linalg_cholesky_ex", "aten::linalg_cholesky")


def read(ctx):
    return host_ops_per_unit(ctx, HOST_OPS)
