"""Replays of the fit's line-search trial graph per fit: the program's
``egobox_torch.lkh_trial`` span, one around each replay, counted in the
window traced with the host's operations. None where the program has no
such span (trials dispatched operator by operator)."""

from portbench.kernels import host_ops_per_unit

HOST_OPS = ("egobox_torch.lkh_trial",)


def read(ctx):
    return host_ops_per_unit(ctx, HOST_OPS)
