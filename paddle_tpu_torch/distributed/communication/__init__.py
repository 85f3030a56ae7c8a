"""``paddle.distributed.communication`` (counterpart: ``paddle_tpu/
distributed/communication``): the collective API of ``collective.py``
and its ``stream`` variants."""
from ..collective import (all_reduce, all_gather, broadcast, reduce,  # noqa: F401
                          scatter, reduce_scatter, alltoall, barrier,
                          send, recv, ReduceOp)
from . import stream  # noqa: F401
