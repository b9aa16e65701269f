"""Static model cost (port of ``fedml_tpu/obs/flops.py``).

Parity with the reference's ptflops check (fedml_api/model/cv/test_cnn.py:
1-13 prints MACs and params). JAX reads XLA's cost analysis of one jitted
forward; the port counts one forward of the model as it runs:

- ``flops`` from ``torch.utils.flop_counter.FlopCounterMode``: the matrix
  products, convolutions and attention that PyTorch has formulas for, and
  the port's own ops through the formulas their modules register (the
  flash forward in ``ops/flash_attention.py``, the GroupNorm forward in
  ``ops/group_norm.py``). Elementwise torch ops count nothing, as in
  ``FlopCounterMode``;
- ``bytes_accessed`` from a dispatch mode that adds up every dispatched
  op's operand and result bytes. That is an unfused count (each op reads
  its inputs from and writes its outputs to memory), so it bounds XLA's
  fused figure from above.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.tree import tree_leaves


def count_params(params) -> int:
    """Elements over the leaves of a parameter tree (nested dicts of
    tensors or arrays)."""
    return int(sum(np.prod(tuple(leaf.shape)) for leaf in tree_leaves(params)))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if torch.is_tensor(t))


class _BytesMode(TorchDispatchMode):
    """Adds up the bytes of each dispatched op's tensor operands and
    results."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def model_cost(model, sample_x, train: bool = False) -> Dict[str, float]:
    """{"flops", "params", "bytes_accessed"} of one forward pass of a
    registry model (an ``nn.Module``) on ``sample_x`` (batched; numpy or a
    tensor), on the device of the model's parameters (of the sample, for a
    model without any)."""
    from fedml_tpu_torch.trainer.local import model_fns

    fns = model_fns(model)
    net = fns.init()
    first = next(iter(model.parameters()), None)
    if first is not None:
        dev = first.device
    else:  # a model without parameters runs where its sample is
        dev = sample_x.device if torch.is_tensor(sample_x) else "cpu"
    x = torch.as_tensor(np.asarray(sample_x) if not torch.is_tensor(sample_x)
                        else sample_x, device=dev)
    # Dropout-bearing models need a key in train mode; a fixed one is fine
    # for a static count.
    rng = keys.key(1, device=dev) if train else None
    counter = FlopCounterMode(display=False)
    nbytes = _BytesMode()
    with torch.no_grad(), counter, nbytes:
        fns.apply(net, x, train=train, rng=rng)
    return {
        "flops": float(counter.get_total_flops()),
        "bytes_accessed": float(nbytes.total),
        "params": count_params(net.params),
    }


def flops_str(cost: Dict[str, float]) -> str:
    """Human-readable 'X.XX GMac, Y.YY M params' (ptflops format)."""
    macs = cost["flops"] / 2.0
    return f"{macs / 1e9:.2f} GMac, {cost['params'] / 1e6:.2f} M params"
