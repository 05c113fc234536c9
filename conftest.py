"""Limits for every test lane of the repo: one time limit on each test, and
the frozen reference's tests that the quick lane cannot afford marked
``slow``.

Every test, the set-up and teardown of its fixtures included, fails once it
has run ``TEST_TIME_LIMIT_S``. The slowest port test took 93-149 s in the
``-n 6`` lane; 300 s is twice that and a fifth of the lane's 1 470 s clock, so
a test that hangs costs its worker five minutes, not the whole run. A test
stuck inside C code, which the limit's signal cannot reach, ends its worker
``BACKSTOP_GRACE_S`` later, and the lane's ``--dist loadfile`` carries on
without it (``pytest_xdist_make_scheduler``).

A test in a file that imports egobox_tpu and not egobox_torch is marked
``slow`` when its own time in the ``-n 6`` lane's junit xml (its call plus
the module set-up it ran first; a test that ended its worker counts as the
limit and the backstop's grace, 360 s) is above T = 30 s. Such a test guards
only the frozen reference, which no change to the port can break; the
port's tests, which hold the port against it, are never marked. The rule was
applied to an uncut run of the lane and once more to the first run after it,
since marking a module's first test hands its compilation to the next: after
the first pass alone the lane took 950 s, after the second it ends in about
half its clock with 698 passes. A higher T leaves more in the lane; a lower
one, or a third pass (692), leaves fewer passes. ``SLOW_REFERENCE_TESTS``
lists them with their seconds in the run that sent them.
"""

import contextlib
import faulthandler
import os
import signal
import sys
import time

import pytest

TEST_TIME_LIMIT_S = 300

# seconds past the limit at which a test stuck in C code ends its process
BACKSTOP_GRACE_S = 60

SLOW_REFERENCE_TESTS = {
    "tests/test_batch.py": (
        "test_batch_feasibility_first_search",  # 136.05
        "test_batch_mesh_sharded_optimizes",  # 86.83
        "test_batch_list_of_problems",  # 81.84
        "test_batch_mixint_integer_portfolio",  # 65.69
        "test_batch_converged_slots_stop_growing",  # 45.83
        "test_batch_batched_callable_and_per_problem_xlimits",  # 45.49
        "test_batch_fuzz_nan_heavy_objective",  # 43.96
        "test_batch_lane_compaction",  # 33.95
        "test_batch_duplicate_proposals_replaced",  # 30.49
        "test_batch_suggest_ask_tell",  # 30.05
        "test_batch_lane_compaction_kill_switch",  # 77.83, second pass
        "test_batch_fuzz_constant_plus_nan",  # 40.13, second pass
    ),
    "tests/test_block_linalg.py": (
        "test_blocked_cholesky_matches_native",  # 32.35, second pass
    ),
    "tests/test_dist_chol.py": (
        "test_distributed_likelihood_matches_single_device",  # 300.01
        "test_cholesky_rowsharded_matches_dense",  # 54.80
        "test_solve_lower_rowsharded_matches_dense",  # 66.25, second pass
    ),
    "tests/test_dist_fit.py": (
        "test_fit_gp_mesh_matches_single_device",  # 360, ended its worker
        "test_fit_gp_mesh_kpls_matches_single_device",  # 360, ended its worker
        "test_dist_grad_matches_single_device",  # 300.04 and 300.00
        "test_blockcyclic_chol_matches_dense",  # 300.04
        "test_dist_stoch_grad_matches_single_device",  # 300.03
        "test_dist_fit_theta_matches_single_device",  # 300.00
        "test_dist_likelihood_failure_returns_neg_inf",  # 236.53
    ),
    "tests/test_dist_model.py": (
        "test_dist_model_predict_parity",  # 300.12
        "test_fit_gp_mesh_returns_dist_model_end_to_end",  # 300.08
        "test_dist_model_kpls",  # 300.04
        "test_dist_posterior_cov_and_sample_parity",  # 300.02
        "test_fit_gp_mesh_materialize_opt_out",  # 300.00
        "test_dist_model_save_raises_with_guidance",  # 258.60
        "test_solve_upperT_blockcyclic_matches_dense",  # 201.50
    ),
    "tests/test_ego.py": (
        "test_full_config_dump",  # 88.81, second pass
        "test_hot_start_checkpoint",  # 56.47, second pass
        "test_function_constraints",  # 54.32, second pass
        "test_egor_service_suggest",  # 41.27, second pass
        "test_nan_in_initial_doe_imputed",  # 30.51, second pass
    ),
    "tests/test_env_features.py": (
        "test_portfolio_env",  # 71.87
    ),
    "tests/test_fused_moe.py": (
        "test_fused_moe_egor_run_quality",  # 151.79
        "test_fused_moe_vs_host_path_quality",  # 78.57
        "test_fused_moe_live_fits_match_per_lane_host_fits",  # 33.95, second
        "test_fused_moe_select_matches_host_surrogates",  # 31.71, second pass
    ),
    "tests/test_fused_run.py": (
        "test_traced_run_q_points_constrained_clmin",  # 360, ended its worker
        "test_traced_run_g24_constrained",  # 284.13
        "test_traced_run_q_points_batch",  # 81.09
        "test_traced_run_traceable_fcstrs",  # 70.61
        "test_traced_run_imputes_nonfinite",  # 60.51
        "test_traced_run_matches_host_loop_quality",  # 50.25
        "test_traced_run_xsinx_finds_optimum",  # 47.17
        "test_traced_run_falls_back_for_host_objective",  # 56.31, second pass
        "test_traced_run_q_optmod",  # 44.66, second pass
        "test_traced_run_target_stop",  # 33.44, second pass
        "test_traced_run_trego_constrained_g24",  # 33.34, second pass
    ),
    "tests/test_fused_step.py": (
        "test_fused_xsinx_golden",  # 68.60
        "test_fused_traceable_fcstr",  # 54.58
        "test_fused_matches_unfused_constrained",  # 50.47
        "test_fused_matches_unfused_unconstrained",  # 44.43
        "test_fused_qei_one_dispatch",  # 50.76, second pass
    ),
    "tests/test_gp.py": (
        "test_multidraw_warmstart",  # 59.43
    ),
    "tests/test_gpqa_cli.py": (
        "test_gpqa_consumes_clustered_recorder_dump",  # 92.52
        "test_gpqa_consumes_recorder_dump",  # 72.00
        "test_sgp_qa_folds_vmapped",  # 33.79
        "test_gpqa_cli",  # 32.45
    ),
    "tests/test_gpx_api.py": (
        "test_sparse_gpx_api",  # 39.75
        "test_gpx_metrics",  # 31.71
    ),
    "tests/test_lbfgsb.py": (
        "test_tr_polish_fit_matches_line_search",  # 105.89
    ),
    "tests/test_mixint.py": (
        "test_int_xsinx",  # 49.91
    ),
    "tests/test_moe_state.py": (
        "test_sparse_expert_mixture_roundtrip",  # 44.06
    ),
    "tests/test_sgp.py": (
        "test_sgp_warmstart_robust_to_bad_dense_basin",  # 360, ended its worker
    ),
    "tests/test_stoch_grad.py": (
        "test_fit_quality_with_stochastic_polish",  # 126.41
        "test_grad_probes_ignored_for_matern",  # 54.27
        "test_estimator_masked_padding_invariant",  # 34.88
        "test_estimator_converges_to_exact",  # 31.68, second pass
    ),
    "tests/test_warm_refit.py": (
        "test_host_and_traced_reduce_at_same_boundary",  # 113.52
        "test_warm_refit_quality_held",  # 116.92, second pass
    ),
}


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # before pytest's own hook deselects by ``-m``
    for item in items:
        path = item.nodeid.split("::", 1)[0]
        if item.originalname in SLOW_REFERENCE_TESTS.get(path, ()):
            item.add_marker(pytest.mark.slow)


_REAL_STDERR = pytest.StashKey[int]()

# (deadline on the monotonic clock, file) of the backstop while a limit
# holds; one per process, as SIGALRM's timer and faulthandler's are
_backstop = None


def pytest_configure(config):
    # pytest's capture is off here: a copy of the real stderr keeps the
    # backstop's stack dump, which a captured stream loses with its process
    config.stash[_REAL_STDERR] = os.dup(sys.stderr.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_REAL_STDERR])


def _arm_backstop():
    deadline, file = _backstop
    faulthandler.dump_traceback_later(max(deadline - time.monotonic(), 0.1),
                                      exit=True, file=file)


@contextlib.contextmanager
def time_limit(seconds, what, grace_s=BACKSTOP_GRACE_S, dump_to=None):
    """Fail ``what`` with ``pytest.fail`` once it has run ``seconds``.

    SIGALRM reaches Python only between bytecodes, so a body stuck inside C
    code (an XLA collective, a gloo rendezvous) does not see it; ``grace_s``
    later faulthandler dumps every thread's stack to ``dump_to`` (stderr by
    default) and ends the process, which pytest-xdist then replaces.
    """
    global _backstop

    def expire(signum, frame):
        pytest.fail(f"{what} ran past its {seconds} s time limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    _backstop = (time.monotonic() + seconds + grace_s,
                 sys.stderr if dump_to is None else dump_to)
    _arm_backstop()
    try:
        yield
    finally:
        _backstop = None
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    # a hook, not an autouse fixture, so that the limit also covers the
    # set-up and teardown of module-scoped fixtures
    with time_limit(TEST_TIME_LIMIT_S, item.nodeid,
                    dump_to=item.config.stash[_REAL_STDERR]):
        return (yield)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """pytest-xdist's ``--dist loadfile``, made to carry on past a worker
    that the backstop ended.

    As it stands it puts the crashed worker's whole workload back in its
    queue: the test that ended the worker, which would end its replacement
    too, and the files it had finished, which the replacement is sent as
    empty batches. And a worker holds its last test until it is sent more or
    shut down, so a replacement handed one file with one test left waits on
    it with the whole lane. Here the crashed test is reported once and not
    run again, finished files are not sent again, and a worker is topped up
    to two pending tests while files are queued.
    """
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduling(LoadFileScheduling):
        def remove_node(self, node):
            workload = self.assigned_work[node]
            pending = [(scope, nodeid) for scope, unit in workload.items()
                       for nodeid, done in unit.items() if not done]
            if not pending:
                return super().remove_node(node)
            scope, crashitem = pending[0]
            workload[scope][crashitem] = True
            for scope in [s for s, unit in workload.items()
                          if all(unit.values())]:
                del workload[scope]
            super().remove_node(node)
            return crashitem

        def _reschedule(self, node):
            super()._reschedule(node)
            while (not node.shutting_down and self.workqueue
                   and self._pending_of(self.assigned_work[node]) < 2):
                self._assign_work_unit(node)

    return Scheduling(config, log)


@pytest.hookimpl(trylast=True)
def pytest_exception_interact():
    # pytest's faulthandler plugin cancels every pending dump when a phase
    # fails; the phases after it (a teardown) keep the backstop
    if _backstop is not None:
        _arm_backstop()
