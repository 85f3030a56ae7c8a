"""The op sweep over the generated element-wise families (unary, binary, compare1, compare) of the op table: each entry through the
reference and the port on the same seeded inputs, outputs (and, where
the entry has ``grad``, gradients) held at ``tolerances_for(spec)``
(``_torch_ops_sweep.py`` holds the machinery)."""
import pytest

from _torch_ops_sweep import (check_grad, check_output, check_pairing, names,
                              on_cpu)  # noqa: F401  (autouse fixture)

FAMILY = "elementwise"


@pytest.mark.parametrize("name", names(FAMILY))
def test_entry_matches_the_reference(name):
    check_pairing(name)


@pytest.mark.parametrize("name", names(FAMILY))
def test_output(name):
    check_output(name)


@pytest.mark.parametrize("name", names(FAMILY, grad=True))
def test_grad(name):
    check_grad(name)


def test_every_reference_entry_has_a_port_entry():
    """The reference's op table (registered and excluded names) is the
    port's, entry for entry, and the port exports every op it declares."""
    import paddle_tpu_torch as port
    from _torch_ops_sweep import (PORT, REF, port_names, reference_names)
    assert port_names() == reference_names()
    assert sorted(PORT) == sorted(REF)
    missing = [n for n, s in PORT.items()
               if s.call is None and not hasattr(port, n)]
    assert not missing, missing
