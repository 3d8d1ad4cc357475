"""Tensor-parallel training at dp = 2, tp = 2: four gloo processes after
`shard_params`, each dp row on its 2 rows of the global batch of 4,
against the JAX `Trainer` after `shard_params` on a 2 x 2 mesh and the
port's plain Trainer, with test_torch_port_tp.py's checks and tolerances
(logs 1e-5; mean gradients 1e-4 of max; weights to 1e-6 where the gradient
is firm, within 2 lr elsewhere). The sharded leaves' gradients are averaged
over the dp group alone, the replicated ones over the world."""
import pytest

from tests import test_torch_port_tp as tp_checks
from tests.torch_port_helpers import (  # noqa: F401 (an autouse fixture)
    one_torch_thread_per_module)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return tp_checks.tp_run(tmp_path_factory, dp=2, tp=2)


def test_each_dp_row_steps_on_its_rows(run):
    assert [r["rows"] for r in run["ranks"]] == [[(0, 2)] * 2] * 2 + [[(2, 4)] * 2] * 2


def test_blocks_and_replicated_tensors(run):
    tp_checks.check_blocks_and_replicas(run)


def test_logs_match_jax_and_one_process(run):
    tp_checks.check_logs(run)


def test_step_matches_jax_after_shard_params(run):
    tp_checks.check_step_against_jax(run)


def test_step_matches_one_process(run):
    tp_checks.check_step_against_one_process(run)


def test_gathered_checkpoint_resumes_at_tp1(run):
    tp_checks.check_resume_at_tp1(run)


def test_tp1_checkpoint_resumes_sharded(run):
    tp_checks.check_tp1_checkpoint_resumes_sharded(run)
