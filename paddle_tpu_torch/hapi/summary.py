"""paddle.summary of the port (counterpart: ``paddle_tpu/hapi/summary.py``):
a table of the network's layers and their parameter counts, and the
totals. A row is printed for the network itself, for every layer that
owns parameters and for every leaf layer, as in the reference; a
parameter shared by two layers counts once in the totals."""
from __future__ import annotations


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    for name, layer in net.named_modules():
        n_params = sum(p.numel() for p in layer._parameters.values()
                       if p is not None)
        if name == "" or n_params or not layer._modules:
            rows.append((name or type(net).__name__,
                         type(layer).__name__, n_params))
    total_params = trainable_params = 0
    for p in net.parameters():   # each parameter once
        total_params += p.numel()
        if p.requires_grad:
            trainable_params += p.numel()
    width = max((len(r[0]) for r in rows), default=20) + 2
    print(f"{'Layer':<{width}}{'Type':<24}{'Params':>12}")
    print("-" * (width + 36))
    for name, typ, n in rows:
        print(f"{name:<{width}}{typ:<24}{n:>12,}")
    print("-" * (width + 36))
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable_params:,}")
    print(f"Non-trainable params: {total_params - trainable_params:,}")
    return {"total_params": total_params,
            "trainable_params": trainable_params}
