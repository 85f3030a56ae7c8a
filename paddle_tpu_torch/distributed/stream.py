"""``paddle.distributed.stream`` (counterpart: ``paddle_tpu/distributed/
stream.py``): the stream variants of the collectives. Each runs the eager
collective on the caller's current stream, as the reference's do;
``sync_op`` rides through and ``use_calc_stream`` is accepted for the
signature."""
from . import collective as _c

__all__ = ["all_reduce", "all_gather", "alltoall", "alltoall_single",
           "broadcast", "reduce", "reduce_scatter", "scatter", "send",
           "recv"]


def all_reduce(tensor, op=None, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_reduce(tensor, op if op is not None else _c.ReduceOp.SUM,
                         group, sync_op=sync_op)


def all_gather(tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_gather(tensor_list, tensor, group)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    return _c.alltoall(out_tensor_list, in_tensor_list, group)


def alltoall_single(out_tensor, in_tensor, out_split_sizes=None,
                    in_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    return _c.alltoall_single(out_tensor, in_tensor, in_split_sizes,
                              out_split_sizes, group)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _c.broadcast(tensor, src, group)


def reduce(tensor, dst=0, op=None, group=None, sync_op=True,
           use_calc_stream=False):
    return _c.reduce(tensor, dst, op if op is not None else _c.ReduceOp.SUM,
                     group)


def reduce_scatter(tensor, tensor_list, op=None, group=None, sync_op=True,
                   use_calc_stream=False):
    return _c.reduce_scatter(tensor, tensor_list,
                             op if op is not None else _c.ReduceOp.SUM,
                             group)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            use_calc_stream=False):
    return _c.scatter(tensor, tensor_list, src, group)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.send(tensor, dst, group)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.recv(tensor, src, group)
