"""``fleet.utils`` of the port (counterpart: ``paddle_tpu/distributed/
fleet/utils/``): ``recompute``, ``recompute_sequential`` (segments),
``recompute_hybrid``, and sequence parallelism."""
from .recompute import recompute
from . import sequence_parallel_utils


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Run a Sequential (or a list of layers) with each of
    ``ctx["segments"]`` segments recomputed (default one: the whole)."""
    if hasattr(functions, "_modules"):
        layers = list(functions._modules.values())
    else:
        layers = list(functions)
    segments = int((ctx or {}).get("segments", 1))
    segments = max(1, min(segments, len(layers)))
    per = (len(layers) + segments - 1) // segments

    def seg_fn(seg):
        def run(x, *rest):
            for lyr in seg:
                x = lyr(x, *rest)
                rest = ()
            return x
        return run

    x = args[0]
    rest = args[1:]
    for i in range(0, len(layers), per):
        x = recompute(seg_fn(layers[i:i + per]), x, *rest, **kwargs)
        rest = ()
    return x


def recompute_hybrid(ctx, function, *args, **kwargs):
    """``recompute`` under hybrid parallelism (``ctx`` carries the mp
    group upstream; the collectives in ``function`` rerun in the backward
    in the same order on every rank, so nothing more is needed)."""
    return recompute(function, *args, **kwargs)
