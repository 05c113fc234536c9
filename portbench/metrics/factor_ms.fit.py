"""Device milliseconds per fit of the kernels launched by the library's
Cholesky and triangular solves (torch.linalg: cuSOLVER, cuBLAS), in the
traced window."""

from portbench.kernels import device_ms_per_unit

HOST_OPS = ("aten::linalg_cholesky_ex", "aten::linalg_cholesky",
            "aten::linalg_solve_triangular", "aten::linalg_solve_ex")


def read(ctx):
    return device_ms_per_unit(ctx, HOST_OPS)
