"""The DARTS search space of FedNAS (port of ``fedml_tpu/models/darts.py``):
the eight candidate ops, the mixed edge, the search cell and network with
the architecture parameters ``alphas_normal``/``alphas_reduce`` at the
root, the genotype derived from them, the retraining network built from a
genotype, and its Graphviz text.

Module and parameter names follow flax's auto-names (``SearchCell_3``,
``MixedOp_5``, ``SepConv_1``, ``FactorizedReduce_0``, ``Conv_2``,
``Norm_1.GroupNorm_0``, ``Dense_0``), each counted per module kind in the
order flax creates them, so ``convert.from_jax_params`` maps the trees one
to one. Numerics follow flax:

- ``padding="SAME"`` is flax's: ``(low, high)`` from :func:`same_pad`,
  asymmetric at stride 2 on even sizes (a 3×3 conv at H 32 pads (0, 1)),
  applied with ``F.pad``; max pool pads with −inf, avg pool counts the
  padded cells (flax's ``count_include_pad=True``);
- a depthwise conv (``feature_group_count=c_in``) is a grouped conv with
  weight ``[c_in, 1, k, k]``;
- GroupNorm through ``ops.group_norm`` (eps 1e-6, groups by
  ``norm_groups``), f32 throughout, as the JAX model has no compute dtype;
  ``norm="bn"`` is ``models/resnet.BatchNorm`` (flax's ``BatchNorm(
  momentum=0.9)``), whose running stats come out of ``model_fns``'s
  train-mode apply as values (FedNAS threads them, ``algos/fednas.py``).

Inputs are NHWC, as in the JAX package; inside, activations are NCHW.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import Norm, _lecun_normal_

PRIMITIVES = (
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
)


def same_pad(size: int, k: int, stride: int = 1,
             dilation: int = 1) -> Tuple[int, int]:
    """flax's (XLA's) ``padding="SAME"`` for one spatial dim: the output
    has ``ceil(size / stride)`` positions, and the padding they need is
    split with the odd cell at the high end."""
    out = -(-size // stride)
    span = (k - 1) * dilation + 1
    total = max((out - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


def pad_same(x, k: int, stride: int = 1, dilation: int = 1,
             value: float = 0.0):
    """``x [N, C, H, W]`` padded for a SAME window of ``k``. (Always an
    explicit pad: a conv's own padding would keep a channels-last input
    channels-last, whose double backward under ``vmap`` torch does not
    implement.)"""
    (ht, hb), (wl, wr) = (same_pad(x.shape[d], k, stride, dilation)
                          for d in (2, 3))
    if ht or hb or wl or wr:
        x = F.pad(x, (wl, wr, ht, hb), value=value)
    return x


def max_pool_same(x, stride: int):
    """flax ``max_pool(x, (3, 3), strides, padding="SAME")``."""
    return F.max_pool2d(pad_same(x, 3, stride, value=-float("inf")), 3,
                        stride)


def avg_pool_same(x, stride: int):
    """flax ``avg_pool(x, (3, 3), strides, padding="SAME")``: the window's
    sum over 9, padded cells included."""
    return F.avg_pool2d(pad_same(x, 3, stride), 3, stride)


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``padding="SAME"``: OIHW weight (``[c_in /
    groups]`` input channels), optional bias."""

    def __init__(self, cin, cout, k, stride=1, dilation=1, groups=1,
                 bias=False, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        _lecun_normal_(self.weight, cin // groups * k * k, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.k, self.stride, self.dilation, self.groups = (k, stride,
                                                           dilation, groups)

    def forward(self, x):
        x = pad_same(x, self.k, self.stride, self.dilation)
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


class _Named(nn.Module):
    """Submodules named as flax names them: ``<Kind>_<n>``, counted per
    kind in creation order."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def named(self, kind: str, module: nn.Module) -> str:
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        name = f"{kind}_{n}"
        self.add_module(name, module)
        return name


class ReLUConvNorm(_Named):
    def __init__(self, cin, cout, k=1, stride=1, norm="gn", gn_fn=None,
                 generator=None):
        super().__init__()
        self.named("Conv", Conv(cin, cout, k, stride, generator=generator))
        self.named("Norm", Norm(norm, cout, gn_fn=gn_fn))

    def forward(self, x):
        return self.Norm_0(self.Conv_0(F.relu(x)))


class SepConv(_Named):
    """Depthwise-separable conv twice (the reference's SepConv)."""

    def __init__(self, cin, cout, k, stride, norm="gn", gn_fn=None,
                 generator=None):
        super().__init__()
        self.layers = []
        for s in (stride, 1):
            dw = self.named("Conv", Conv(cin, cin, k, s, groups=cin,
                                         generator=generator))
            pw = self.named("Conv", Conv(cin, cout, 1, generator=generator))
            nm = self.named("Norm", Norm(norm, cout, gn_fn=gn_fn))
            self.layers.append((dw, pw, nm))
            cin = cout

    def forward(self, x):
        for dw, pw, nm in self.layers:
            x = getattr(self, nm)(getattr(self, pw)(getattr(self, dw)(
                F.relu(x))))
        return x


class DilConv(_Named):
    """Dilated (2) depthwise-separable conv (the reference's DilConv)."""

    def __init__(self, cin, cout, k, stride, norm="gn", gn_fn=None,
                 generator=None):
        super().__init__()
        self.named("Conv", Conv(cin, cin, k, stride, dilation=2, groups=cin,
                                generator=generator))
        self.named("Conv", Conv(cin, cout, 1, generator=generator))
        self.named("Norm", Norm(norm, cout, gn_fn=gn_fn))

    def forward(self, x):
        return self.Norm_0(self.Conv_1(self.Conv_0(F.relu(x))))


class FactorizedReduce(_Named):
    """Stride-2 reduce of a skip edge: two 1×1 stride-2 convs, the second on
    x shifted by one row and column (padded back on odd sizes so that both
    give ``ceil(H / 2)``), concatenated."""

    def __init__(self, cin, cout, norm="gn", gn_fn=None, generator=None):
        super().__init__()
        self.named("Conv", Conv(cin, cout // 2, 1, 2, generator=generator))
        self.named("Conv", Conv(cin, cout - cout // 2, 1, 2,
                                generator=generator))
        self.named("Norm", Norm(norm, cout, gn_fn=gn_fn))

    def forward(self, x):
        x = F.relu(x)
        a = self.Conv_0(x)
        shifted = x[:, :, 1:, 1:]
        pad_h, pad_w = x.shape[2] % 2, x.shape[3] % 2
        if pad_h or pad_w:
            shifted = F.pad(shifted, (0, pad_w, 0, pad_h))
        b = self.Conv_1(shifted)
        return self.Norm_0(torch.cat([a, b], dim=1))


def _op(cell: _Named, name: str, c: int, stride: int, norm, gn_fn, gen):
    """The module of op ``name`` added to ``cell``: its flax name, or None
    for the ops without parameters (pools, identity skip)."""
    if name in ("max_pool_3x3", "avg_pool_3x3") or (
            name == "skip_connect" and stride == 1):
        return None
    if name == "skip_connect":
        return cell.named("FactorizedReduce",
                          FactorizedReduce(c, c, norm, gn_fn, gen))
    k = int(name[-1])
    if name.startswith("sep_conv"):
        return cell.named("SepConv", SepConv(c, c, k, stride, norm, gn_fn,
                                             gen))
    if name.startswith("dil_conv"):
        return cell.named("DilConv", DilConv(c, c, k, stride, norm, gn_fn,
                                             gen))
    raise ValueError(f"unknown genotype op {name!r}")


def _run_op(cell, name: str, module, x, stride: int):
    if name == "max_pool_3x3":
        return max_pool_same(x, stride)
    if name == "avg_pool_3x3":
        return avg_pool_same(x, stride)
    if module is None:  # skip at stride 1
        return x
    return getattr(cell, module)(x)


class MixedOp(_Named):
    """The softmax-weighted sum of every candidate op on one edge. The
    ``none`` op is zeros of the output's shape, ``ceil(H / s)``: its term
    is 0 and is left out of the sum (JAX adds ``w[0]·0``, which changes no
    value)."""

    def __init__(self, c, stride, norm="gn", gn_fn=None, generator=None):
        super().__init__()
        self.stride = stride
        self.ops = [(prim, _op(self, prim, c, stride, norm, gn_fn, generator))
                    for prim in PRIMITIVES[1:]]

    def forward(self, x, w):
        w = w.unbind(0)
        acc = None
        for i, (prim, module) in enumerate(self.ops, start=1):
            term = w[i] * _run_op(self, prim, module, x, self.stride)
            acc = term if acc is None else acc + term
        return acc


def n_edges(steps: int) -> int:
    return sum(2 + i for i in range(steps))


def _preprocess(cell: _Named, c_pp, c_p, c, reduction_prev, norm, gn_fn,
                gen):
    if reduction_prev:
        p0 = cell.named("FactorizedReduce",
                        FactorizedReduce(c_pp, c, norm, gn_fn, gen))
    else:
        p0 = cell.named("ReLUConvNorm",
                        ReLUConvNorm(c_pp, c, 1, 1, norm, gn_fn, gen))
    p1 = cell.named("ReLUConvNorm", ReLUConvNorm(c_p, c, 1, 1, norm, gn_fn,
                                                 gen))
    return p0, p1


class SearchCell(_Named):
    """DARTS cell: ``steps`` intermediate nodes with a mixed edge from every
    predecessor; the output is the concat of the last ``multiplier``."""

    def __init__(self, c_pp, c_p, c, steps=4, multiplier=4, reduction=False,
                 reduction_prev=False, norm="gn", gn_fn=None,
                 generator=None):
        super().__init__()
        self.steps, self.multiplier = steps, multiplier
        self.pre = _preprocess(self, c_pp, c_p, c, reduction_prev, norm,
                               gn_fn, generator)
        self.edges = []
        for i in range(steps):
            for j in range(2 + i):
                stride = 2 if reduction and j < 2 else 1
                self.edges.append(self.named(
                    "MixedOp", MixedOp(c, stride, norm, gn_fn, generator)))

    def forward(self, s0, s1, weights):
        weights = weights.unbind(0)
        states = [getattr(self, self.pre[0])(s0),
                  getattr(self, self.pre[1])(s1)]
        offset = 0
        for _ in range(self.steps):
            acc = None
            for j, h in enumerate(states):
                o = getattr(self, self.edges[offset + j])(
                    h, weights[offset + j])
                acc = o if acc is None else acc + o
            offset += len(states)
            states.append(acc)
        return torch.cat(states[-self.multiplier:], dim=1)


def _reductions(layers: int):
    return {layers // 3, 2 * layers // 3} - {0}


class DartsNetwork(nn.Module):
    """The search network (the reference's model_search.py Network)."""

    def __init__(self, c=16, layers=8, steps=4, multiplier=4,
                 stem_multiplier=3, num_classes=10, norm="gn", gn_fn=None,
                 generator=None):
        super().__init__()
        if multiplier > steps:
            raise ValueError(
                f"multiplier ({multiplier}) must be <= steps ({steps}): a "
                "cell concatenates its last `multiplier` INTERMEDIATE nodes, "
                "and there are only `steps` of them")
        self.steps, self.multiplier = steps, multiplier
        e, k = n_edges(steps), len(PRIMITIVES)
        self.alphas_normal = nn.Parameter(
            torch.randn(e, k, generator=generator) * 1e-3)
        self.alphas_reduce = nn.Parameter(
            torch.randn(e, k, generator=generator) * 1e-3)
        c_curr = stem_multiplier * c
        self.Conv_0 = Conv(3, c_curr, 3, generator=generator)
        self.Norm_0 = Norm(norm, c_curr, gn_fn=gn_fn)
        c_pp = c_p = c_curr
        c_curr, reduction_prev = c, False
        self.reduction = []
        for layer in range(layers):
            reduction = layer in _reductions(layers)
            if reduction:
                c_curr *= 2
            self.add_module(f"SearchCell_{layer}", SearchCell(
                c_pp, c_p, c_curr, steps, multiplier, reduction,
                reduction_prev, norm, gn_fn, generator))
            self.reduction.append(reduction)
            c_pp, c_p = c_p, multiplier * c_curr
            reduction_prev = reduction
        self.Dense_0 = nn.Linear(c_p, num_classes)
        _lecun_normal_(self.Dense_0.weight, c_p, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x):  # x [B, H, W, 3]
        w_normal = torch.softmax(self.alphas_normal, dim=-1)
        w_reduce = torch.softmax(self.alphas_reduce, dim=-1)
        s0 = s1 = self.Norm_0(self.Conv_0(x.permute(0, 3, 1, 2)))
        for layer, reduction in enumerate(self.reduction):
            cell = getattr(self, f"SearchCell_{layer}")
            s0, s1 = s1, cell(s0, s1, w_reduce if reduction else w_normal)
        return self.Dense_0(s1.mean(dim=(2, 3)))


class Genotype(NamedTuple):
    normal: Sequence[Tuple[str, int]]
    normal_concat: Sequence[int]
    reduce: Sequence[Tuple[str, int]]
    reduce_concat: Sequence[int]


def derive_genotype(alphas_normal, alphas_reduce, steps: int = 4,
                    multiplier: int = 4) -> Genotype:
    """The reference's model_search.py genotype(): per node, keep the two
    incoming edges with the strongest non-none op; record (op, src)."""

    def parse(alphas):
        if torch.is_tensor(alphas):
            alphas = alphas.detach().to("cpu", torch.float32)
        w = np.asarray(alphas, np.float32)
        w = np.exp(w - w.max(-1, keepdims=True))
        w = w / w.sum(-1, keepdims=True)
        gene, offset = [], 0
        none_idx = PRIMITIVES.index("none")
        names = [p for p in PRIMITIVES if p != "none"]
        for i in range(steps):
            n_in = 2 + i
            rows = w[offset:offset + n_in]
            scored = []
            for j in range(n_in):
                ops = np.delete(rows[j], none_idx)
                best = int(np.argmax(ops))
                scored.append((float(ops[best]), names[best], j))
            scored.sort(reverse=True)
            for _, name, j in scored[:2]:
                gene.append((name, j))
            offset += n_in
        return gene

    concat = list(range(2 + steps - multiplier, steps + 2))
    return Genotype(parse(alphas_normal), concat, parse(alphas_reduce), concat)


class GenotypeCell(_Named):
    """Discrete cell of a searched genotype (the retraining model, the
    reference's darts/model.py Cell): each intermediate node sums its two
    chosen ops; the output is the concat of the genotype's concat nodes."""

    def __init__(self, genotype: Genotype, c_pp, c_p, c, reduction=False,
                 reduction_prev=False, norm="gn", gn_fn=None,
                 generator=None):
        super().__init__()
        self.pre = _preprocess(self, c_pp, c_p, c, reduction_prev, norm,
                               gn_fn, generator)
        gene = genotype.reduce if reduction else genotype.normal
        self.concat = tuple(genotype.reduce_concat if reduction
                            else genotype.normal_concat)
        self.ops = []
        for name, src in gene:
            stride = 2 if reduction and src < 2 else 1
            self.ops.append((name, src, stride,
                             _op(self, name, c, stride, norm, gn_fn,
                                 generator)))

    def forward(self, s0, s1):
        states = [getattr(self, self.pre[0])(s0),
                  getattr(self, self.pre[1])(s1)]
        for i in range(0, len(self.ops), 2):
            acc = None
            for name, src, stride, module in self.ops[i:i + 2]:
                o = _run_op(self, name, module, states[src], stride)
                acc = o if acc is None else acc + o
            states.append(acc)
        return torch.cat([states[k] for k in self.concat], dim=1)


class GenotypeNetwork(nn.Module):
    """Retraining network of a fixed genotype (the reference's
    darts/model.py NetworkCIFAR): stem, cells with reductions at 1/3 and
    2/3 of the depth, pooled classifier."""

    def __init__(self, genotype: Genotype, num_classes=10, c=36, layers=8,
                 stem_multiplier=3, norm="gn", gn_fn=None, generator=None):
        super().__init__()
        c_curr = stem_multiplier * c
        self.Conv_0 = Conv(3, c_curr, 3, generator=generator)
        self.Norm_0 = Norm(norm, c_curr, gn_fn=gn_fn)
        c_pp = c_p = c_curr
        reduction_prev = False
        self.layers = layers
        for i in range(layers):
            reduction = i in _reductions(layers)
            if reduction:
                c *= 2
            cell = GenotypeCell(genotype, c_pp, c_p, c, reduction,
                                reduction_prev, norm, gn_fn, generator)
            self.add_module(f"GenotypeCell_{i}", cell)
            c_pp, c_p = c_p, len(cell.concat) * c
            reduction_prev = reduction
        self.Dense_0 = nn.Linear(c_p, num_classes)
        _lecun_normal_(self.Dense_0.weight, c_p, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x):  # x [B, H, W, 3]
        s0 = s1 = self.Norm_0(self.Conv_0(x.permute(0, 3, 1, 2)))
        for i in range(self.layers):
            s0, s1 = s1, getattr(self, f"GenotypeCell_{i}")(s0, s1)
        return self.Dense_0(s1.mean(dim=(2, 3)))


@register_model("darts")
def darts(num_classes: int = 10, c: int = 16, layers: int = 8,
          steps: int = 4, multiplier: int = 4, norm: str = "gn",
          device=None, gn_fn=None, generator=None, **_):
    dev = resolve_device(device)
    return DartsNetwork(c=c, layers=layers, steps=steps,
                        multiplier=multiplier, num_classes=num_classes,
                        norm=norm, gn_fn=gn_fn, generator=generator).to(dev)


@register_model("darts_genotype")
def darts_genotype(genotype: Genotype, num_classes: int = 10, c: int = 16,
                   layers: int = 8, norm: str = "gn", device=None,
                   gn_fn=None, generator=None, **_):
    """Retrain a searched architecture (the reference's darts/train.py)."""
    dev = resolve_device(device)
    genotype = Genotype(
        tuple(tuple(e) for e in genotype.normal),
        tuple(genotype.normal_concat),
        tuple(tuple(e) for e in genotype.reduce),
        tuple(genotype.reduce_concat),
    )
    return GenotypeNetwork(genotype=genotype, num_classes=num_classes, c=c,
                           layers=layers, norm=norm, gn_fn=gn_fn,
                           generator=generator).to(dev)


def genotype_to_dot(genotype: Genotype, which: str = "normal",
                    name: str = "cell") -> str:
    """One cell of a genotype as Graphviz DOT text (the role of the
    reference's darts visualizer, without the ``graphviz`` package): the
    two input states ``c_{k-2}``/``c_{k-1}``, the intermediate steps and
    ``c_{k}``; one labeled edge per (op, src) entry; concat edges into
    ``c_{k}``."""
    if which not in ("normal", "reduce"):
        raise ValueError(f"which must be 'normal' or 'reduce', got {which!r}")
    edges = getattr(genotype, which)
    concat = getattr(genotype, f"{which}_concat")
    steps = len(edges) // 2

    def node(i: int) -> str:
        return {0: '"c_{k-2}"', 1: '"c_{k-1}"'}.get(i, f'"{i - 2}"')

    lines = [
        f'digraph "{name}_{which}" {{',
        "  rankdir=LR;",
        '  node [shape=box style=rounded];',
        '  "c_{k-2}" [shape=oval];',
        '  "c_{k-1}" [shape=oval];',
        '  "c_{k}" [shape=oval];',
    ]
    for step in range(steps):
        for op, src in edges[2 * step: 2 * step + 2]:
            lines.append(f'  {node(src)} -> "{step}" [label="{op}"];')
    for src in concat:
        lines.append(f'  {node(src)} -> "c_{{k}}";')
    lines.append("}")
    return "\n".join(lines)
