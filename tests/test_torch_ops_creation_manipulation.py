"""The op sweep over the creation and manipulation rows of the op table: each entry through the
reference and the port on the same seeded inputs, outputs (and, where
the entry has ``grad``, gradients) held at ``tolerances_for(spec)``
(``_torch_ops_sweep.py`` holds the machinery)."""
import pytest

from _torch_ops_sweep import (check_output, check_pairing, names,
                              on_cpu)  # noqa: F401  (autouse fixture)

FAMILY = "creation_manipulation"


@pytest.mark.parametrize("name", names(FAMILY))
def test_entry_matches_the_reference(name):
    check_pairing(name)


@pytest.mark.parametrize("name", names(FAMILY))
def test_output(name):
    check_output(name)



def test_no_row_declares_a_gradient():
    """None of these rows has ``grad``: their gradients are held in the
    other families' files."""
    assert names(FAMILY, grad=True) == []


def test_random_ops_by_moments_and_seeded_reruns():
    """The stochastic rows (scoped out of the numeric sweep): each random
    op's sample mean and variance against its distribution's, the same
    values after the same ``paddle.seed``, others after another."""
    from paddle_tpu_torch.ops.sweep import random_checks
    report, failures = random_checks("cpu")
    assert not failures, failures
    assert len(report) == 20
