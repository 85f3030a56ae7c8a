"""``paddle.distributed.communication.stream``: the stream variants."""
from ..stream import (all_reduce, all_gather, broadcast, reduce,  # noqa: F401
                      scatter, reduce_scatter, alltoall, alltoall_single,
                      send, recv)
