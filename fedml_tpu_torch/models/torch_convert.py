"""Reference torch ``.pth`` checkpoints into the port's models (port of
``fedml_tpu/models/torch_convert.py``).

The reference ships pretrained CIFAR ResNet weights as torch state dicts
(``resnet56(pretrained=True, path=...)``, ``{'state_dict': ...}`` with
DataParallel's ``module.`` prefix). :func:`convert_torch_cifar_resnet`
maps such a state dict onto the port's ``CifarResNet(norm="bn")``
``NetState``, and :func:`convert_torch_gkt_client` /
:func:`convert_torch_gkt_server` onto the split pair
(``models/resnet_split.py``): weights, biases and BatchNorm running stats.
The port keeps torch's layouts (conv OIHW, linear ``[out, in]``), so only
the names change: ``conv1``/``bn1``/``fc`` → ``Conv_0``/``Norm_0``/
``Dense_0``, ``layer{s}.{j}.conv{k}`` → ``<Block>_{i}.Conv_{k-1}``,
``bn{k}`` → ``Norm_{k-1}.BatchNorm_0`` (``weight``/``bias``,
``running_mean``/``running_var`` → ``mean``/``var``), the downsample's
``0``/``1`` → ``downsample``/``Norm_{n}``. ``num_batches_tracked`` is
dropped. Both directions are strict: every leaf of the model must find its
tensor at its shape, and every tensor must be used.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from fedml_tpu_torch.trainer.local import NetState

_SUFFIX = {"weight": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}


def _torch_key(name: str, layers: Sequence[int]) -> str:
    """The reference torch name of one port leaf (``NetState`` params or
    model state) of a CIFAR ResNet or a split half."""
    parts = name.split(".")
    head, leaf = parts[0], parts[-1]
    suffix = _SUFFIX[leaf]
    if head == "Conv_0":
        return "conv1.weight"
    if head == "Norm_0":
        return f"bn1.{suffix}"
    if head == "Dense_0":
        return f"fc.{suffix}"
    if head.startswith(("BottleneckBlock_", "BasicBlock_")):
        blk = int(head.split("_")[1])
        stage, offset = 0, 0
        while blk - offset >= layers[stage]:
            offset += layers[stage]
            stage += 1
        prefix = f"layer{stage + 1}.{blk - offset}"
        part = parts[1]
        if part == "downsample":
            return f"{prefix}.downsample.0.weight"
        if part.startswith("Conv_"):
            return f"{prefix}.conv{int(part.split('_')[1]) + 1}.{suffix}"
        if part.startswith("Norm_"):
            j = int(part.split("_")[1])
            n_main = 3 if head.startswith("Bottleneck") else 2
            if j == n_main:  # the downsample branch's norm
                return f"{prefix}.downsample.1.{suffix}"
            return f"{prefix}.bn{j + 1}.{suffix}"
    raise KeyError(f"no torch mapping for the port's {name!r}")


def _strip(state_dict: Dict) -> Dict:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def convert_torch_cifar_resnet(state_dict: Dict, net: NetState,
                               layers: Sequence[int] = (6, 6, 6)
                               ) -> NetState:
    """``net`` (a ``CifarResNet(norm="bn")`` NetState) with the reference
    torch state dict's tensors, on ``net``'s devices and dtypes. Refuses a
    stem of another geometry (``stem="s2d"``), a missing tensor, a shape
    mismatch and leftover tensors."""
    sd = {k: v for k, v in _strip(state_dict).items()
          if not k.endswith("num_batches_tracked")}
    stem, ref = net.params.get("Conv_0.weight"), sd.get("conv1.weight")
    if stem is not None and ref is not None and (
            tuple(stem.shape[:2]) != tuple(torch.as_tensor(ref).shape[:2])):
        raise ValueError(
            f"model stem conv is {stem.shape[1]}->{stem.shape[0]} channels "
            f"but the torch checkpoint's conv1 is {ref.shape[1]}->"
            f"{ref.shape[0]}: this net's geometry cannot map onto the "
            "reference weights (stem='s2d' has no reference checkpoint)")
    used = set()

    def rebuild(tree):
        out = {}
        for name, leaf in tree.items():
            tk = _torch_key(name, layers)
            if tk not in sd:
                raise KeyError(f"torch checkpoint is missing {tk!r} (wanted "
                               f"by the port's {name!r})")
            val = torch.as_tensor(sd[tk])
            if tuple(val.shape) != tuple(leaf.shape):
                raise ValueError(f"{tk!r} has shape {tuple(val.shape)}, the "
                                 f"port's {name!r} {tuple(leaf.shape)}")
            used.add(tk)
            out[name] = val.to(leaf.device, leaf.dtype).clone()
        return out

    out = NetState(rebuild(net.params), rebuild(net.model_state))
    leftover = set(sd) - used
    if leftover:
        raise ValueError(
            f"torch checkpoint has {len(leftover)} unused tensors (first: "
            f"{sorted(leftover)[:3]}) — architecture mismatch?")
    return out


def convert_torch_gkt_client(state_dict: Dict, net: NetState,
                             n_blocks: int = 1) -> NetState:
    """A reference GKT client stump (``resnet5_56``/``resnet8_56``: the
    conv1/bn1 stem, ``layer1`` only, ``fc``) onto a
    ``ResNetClientStump(norm="bn")`` NetState."""
    return convert_torch_cifar_resnet(state_dict, net, layers=(n_blocks,))


def convert_torch_gkt_server(state_dict: Dict, net: NetState,
                             layers: Sequence[int] = (6, 6, 6)) -> NetState:
    """A reference GKT server tail onto a ``ResNetServerTail(norm="bn")``
    NetState. The reference server net builds a conv1/bn1 stem that its
    forward never runs: those tensors are dropped, and the strict leftover
    check applies to the rest."""
    stem = ("conv1.weight", "bn1.weight", "bn1.bias", "bn1.running_mean",
            "bn1.running_var", "bn1.num_batches_tracked")
    return convert_torch_cifar_resnet(
        {k: v for k, v in _strip(state_dict).items() if k not in stem}, net,
        layers)


def _load_state_dict(path: str) -> Dict:
    # weights_only: a dict of tensors, never pickled code.
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt


def load_torch_checkpoint(path: str, net: NetState,
                          layers: Sequence[int] = (6, 6, 6)) -> NetState:
    """A reference ``.pth`` (``{'state_dict': ...}`` or a bare state dict,
    ``module.`` prefixes included) into ``net``."""
    return convert_torch_cifar_resnet(_load_state_dict(path), net, layers)


def load_torch_gkt_checkpoint(path: str, net: NetState, *, role: str,
                              n_blocks: int = 1,
                              layers: Sequence[int] = (6, 6, 6)) -> NetState:
    """A reference GKT ``.pth`` into the matching half: ``role="client"``
    (the stump) or ``role="server"`` (the tail)."""
    if role not in ("client", "server"):
        raise ValueError(f"role must be 'client' or 'server', got {role!r}")
    sd = _load_state_dict(path)
    if role == "client":
        return convert_torch_gkt_client(sd, net, n_blocks=n_blocks)
    return convert_torch_gkt_server(sd, net, layers=layers)
