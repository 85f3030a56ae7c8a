"""paddle.flops of the port (counterpart: ``paddle_tpu/hapi/flops.py``):
forward operations per leaf layer, counted by forward hooks over one run
on a zero input, in the reference's convention: a convolution or linear
layer counts its multiply-accumulates, a normalization two passes over
its input, an average pool one per output, anything else zero.
``custom_ops`` maps a layer class to its own ``fn(layer, inputs,
output)``."""
from __future__ import annotations

import torch


def _count(layer, inputs, output):
    from .. import nn
    x = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
    if isinstance(layer, (nn.Conv1D, nn.Conv2D, nn.Conv3D)):
        w = layer.weight
        return output.numel() * (w.numel() // int(w.shape[0]))
    if isinstance(layer, nn.Linear):
        return output.numel() * int(layer.weight.shape[0])
    if isinstance(layer, (nn.BatchNorm, nn.BatchNorm1D, nn.BatchNorm2D,
                          nn.BatchNorm3D, nn.LayerNorm)):
        return 2 * x.numel()
    if isinstance(layer, (nn.AvgPool1D, nn.AvgPool2D, nn.AvgPool3D,
                          nn.AdaptiveAvgPool1D, nn.AdaptiveAvgPool2D,
                          nn.AdaptiveAvgPool3D)):
        return output.numel()
    return 0


def _device(net):
    for t in net.parameters():
        return t.device
    return torch.device("cpu")


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Forward operations of ``net`` on one zero input of ``input_size``
    (the batch included), on the network's device."""
    counts = {}
    handles = []

    def make_hook(name):
        def hook(layer, inputs, output):
            fn = custom_ops.get(type(layer)) if custom_ops else None
            n = fn(layer, inputs, output) if fn \
                else _count(layer, inputs, output)
            counts[name] = counts.get(name, 0) + int(n)
        return hook

    for name, layer in net.named_modules():
        if not layer._modules:   # leaves only: nothing counted twice
            handles.append(layer.register_forward_hook(
                make_hook(name or type(layer).__name__)))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(list(input_size), device=_device(net)))
    finally:
        for h in handles:
            h.remove()
        net.train(was_training)
    total = sum(counts.values())
    if print_detail:
        width = max((len(k) for k in counts), default=10) + 2
        print(f"{'Layer':<{width}}{'FLOPs':>16}")
        for k, v in counts.items():
            print(f"{k:<{width}}{v:>16,}")
        print(f"{'Total':<{width}}{total:>16,}")
    return total
