"""The op sweep over the indexing, reduction/sort, element-math and linalg rows of the op table: each entry through the
reference and the port on the same seeded inputs, outputs (and, where
the entry has ``grad``, gradients) held at ``tolerances_for(spec)``
(``_torch_ops_sweep.py`` holds the machinery)."""
import pytest

from _torch_ops_sweep import (check_grad, check_output, check_pairing, names,
                              on_cpu)  # noqa: F401  (autouse fixture)

FAMILY = "indexing_reductions_linalg"


@pytest.mark.parametrize("name", names(FAMILY))
def test_entry_matches_the_reference(name):
    check_pairing(name)


@pytest.mark.parametrize("name", names(FAMILY))
def test_output(name):
    check_output(name)


@pytest.mark.parametrize("name", names(FAMILY, grad=True))
def test_grad(name):
    check_grad(name)
