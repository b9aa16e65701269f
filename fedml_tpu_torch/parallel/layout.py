"""Compute layouts: the logical model, a padded client step (port of
``fedml_tpu/parallel/layout.py``).

The **logical** model is what clients train against, the server
averages, checkpoints store and every bit-equality pin sees; it keeps its
shapes everywhere. The local trainer runs a **physical** twin whose
channel dims are padded up (:func:`compute_layout`) or whose stem conv is
rephrased (:func:`im2col_layout`), through a pad-on-entry / slice-on-exit
wrapper (:func:`wrap_local_train`): padding never crosses the client step.

The padded twin is exact: every pad entry of the params is zero and stays
zero through training (zero input channels add nothing forward, and the
pad filters get zero gradient back, since the classifier's pad rows are
zero). GroupNorm is the layer where padding could leak: the pad channels
fill WHOLE extra groups of the logical group size
(``models/resnet.Norm(logical_channels=...)``), where they normalize to
exactly zero, and :func:`pad_channels` bakes that into the pad quantum.
Dropout models are refused (their masks' shapes follow the physical
layout), and so is DP noise (its per-parameter draw does too).

The port's layouts work on ``nn.Module`` state dicts: a leaf is a
parameter or buffer name (``BottleneckBlock_0.Conv_1.weight``, OIHW), and
its logical block is the leading slice of every dim, except for the
overrides: the CNN's flatten boundary (``Dense_0.weight``, whose input
dim interleaves (h, w, c)) and the im2col stem (``Conv_0.weight``, a
reshape). ``pad``/``unpad`` work on the trailing dims of each leaf and
leave any leading batch dims (a client stack) as they are.

**The padding unit on the H100.** JAX pads to the TPU's 128 lanes and 8
sublanes. The card's tensor cores take a convolution in channels-last
bf16 without cuDNN padding its channels when they are a multiple of 8
(16 bytes of bf16, one ``ldmatrix`` row), and a wgmma K-step reads 64
bf16 (128 bytes, one swizzled smem row); so :func:`compute_layout`
defaults to ``sublane=8``, ``lane=64``: widths round up to multiples of
8 and snap to the next multiple of 64 when within ``lane_snap`` x 64 of
it. In f32 with TF32 off the convolutions run on the FMA pipes, where
padding is pure extra work: the layout can pay, if at all, in bf16.
:class:`LayoutPolicy`'s own defaults are JAX's, so that a policy built
with no arguments pads as the JAX package does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch.nn.functional as F

from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg
from fedml_tpu_torch.models.lr import LogisticRegression
from fedml_tpu_torch.models.resnet import CifarResNet, norm_groups
from fedml_tpu_torch.trainer.local import NetState

#: The card's padding unit (see the module docstring).
CARD_LANE, CARD_SUBLANE = 64, 8


@dataclass(frozen=True)
class LayoutPolicy:
    """Round channel dims up to ``sublane`` multiples, and snap to the next
    ``lane`` multiple when already within ``lane_snap`` of it (96 → 128 at
    JAX's 128 lanes; 16 stays 16)."""

    lane: int = 128
    sublane: int = 8
    lane_snap: float = 0.25


def pad_width(c: int, policy: LayoutPolicy) -> int:
    """The policy's physical width for ``c`` logical channels (before any
    GroupNorm quantum)."""
    target = -(-c // policy.sublane) * policy.sublane
    next_lane = -(-c // policy.lane) * policy.lane
    if (next_lane - c) <= policy.lane_snap * policy.lane:
        target = max(target, next_lane)
    return target


def pad_channels(c: int, policy: LayoutPolicy, quanta: Tuple[int, ...] = ()
                 ) -> int:
    """The smallest width >= the policy's target that is a multiple of the
    sublane and of every ``quanta`` entry (the GroupNorm group sizes where
    the width appears), never below ``c``."""
    q = math.lcm(policy.sublane, *quanta) if quanta else policy.sublane
    target = max(pad_width(c, policy), c)
    return max(-(-target // q) * q, c)


def _pad_spec(logical, physical):
    if len(logical) != len(physical) or any(
            p < l for l, p in zip(logical, physical)):
        raise ValueError(f"physical leaf {physical} does not embed logical "
                         f"{logical}")
    return tuple(p - l for l, p in zip(logical, physical))


def _state_shapes(module):
    return ({k: tuple(v.shape) for k, v in module.named_parameters()},
            {k: tuple(v.shape) for k, v in module.named_buffers()})


@dataclass
class ComputeLayout:
    """The logical ↔ physical mapping of one model: the physical twin
    module and ``pad``/``unpad`` over ``NetState``s (params and buffers),
    exact inverses on the logical block. ``overrides``: ``{leaf name:
    (pad_leaf, unpad_leaf)}`` for leaves whose logical block is not a
    leading slice; each takes the leaf with any leading batch dims."""

    logical_model: Any
    physical_model: Any
    overrides: Dict[str, Tuple[Callable, Callable]] = field(
        default_factory=dict)
    #: (params, model_state) of ``{name: (logical shape, pad or None)}``.
    _leaves: Any = None

    def _build_specs(self):
        log_p, log_s = _state_shapes(self.logical_model)
        phys_p, phys_s = _state_shapes(self.physical_model)
        trees = []
        for log, phys in ((log_p, phys_p), (log_s, phys_s)):
            if list(log) != list(phys):
                raise ValueError(
                    "logical and physical models have different param trees")
            trees.append({k: (log[k], None if k in self.overrides
                              else _pad_spec(log[k], phys[k]))
                          for k in log})
        unknown = set(self.overrides) - set(trees[0]) - set(trees[1])
        if unknown:
            raise ValueError(f"override names not in the param tree: "
                             f"{sorted(unknown)}")
        self._leaves = tuple(trees)

    @property
    def is_identity(self) -> bool:
        return not self.overrides and all(
            not any(spec) for tree in self._leaves
            for _, spec in tree.values())

    def _apply(self, tree, specs, which: int):
        out = {}
        for name, leaf in tree.items():
            shape, spec = specs[name]
            if spec is None:
                out[name] = self.overrides[name][which](leaf)
            elif not any(spec):
                out[name] = leaf
            elif which == 0:  # pad the trailing dims' tails with zeros
                out[name] = F.pad(leaf, [v for hi in reversed(spec)
                                         for v in (0, hi)])
            else:  # the leading block of the trailing dims
                for d, s in enumerate(shape):
                    leaf = leaf.narrow(d - len(shape), 0, s)
                out[name] = leaf
        return out

    def pad(self, net: NetState) -> NetState:
        """Logical ``NetState`` → physical, the pad block zero."""
        return NetState(self._apply(net.params, self._leaves[0], 0),
                        self._apply(net.model_state, self._leaves[1], 0))

    def unpad(self, net: NetState) -> NetState:
        """Physical ``NetState`` → logical (the leading block)."""
        return NetState(self._apply(net.params, self._leaves[0], 1),
                        self._apply(net.model_state, self._leaves[1], 1))

    def describe(self) -> Dict[str, Any]:
        """Leaves, padded leaves, logical param count, identity."""
        leaves = [v for tree in self._leaves for v in tree.values()]
        return {"leaves": len(leaves),
                "padded_leaves": sum(1 for _, s in leaves
                                     if s is None or any(s)),
                "logical_params": int(sum(math.prod(shape)
                                          for shape, _ in leaves)),
                "identity": self.is_identity}


# --- the families' physical twins --------------------------------------------

def _cifar_resnet_twin(model, policy: LayoutPolicy):
    cfg = model.config
    if cfg["norm"] not in ("gn", "bn", "none"):
        raise NotImplementedError(
            f"compute_layout supports CifarResNet norm in gn|bn|none; got "
            f"{cfg['norm']!r}")
    if cfg["logical_widths"] or cfg["logical_stem"]:
        raise ValueError("model is already a padded physical twin")
    stem_ch, widths = model.stage_widths(cfg["stem"], cfg["widths"],
                                         cfg["stem_width"])
    gn = cfg["norm"] == "gn"

    def quanta(width, scales):
        # The GroupNorms a stage width feeds (x1 in the block, x4 at its
        # output): a physical p appears as p·scale channels there, which
        # must hold whole logical groups: p % (cpg / gcd(scale, cpg)) == 0.
        if not gn:
            return ()
        out = []
        for scale in scales:
            c = width * scale
            cpg = c // norm_groups(c)
            out.append(cpg // math.gcd(scale, cpg))
        return tuple(out)

    p_widths = tuple(pad_channels(w, policy, quanta(w, (1, 4)))
                     for w in widths)
    p_stem = pad_channels(stem_ch, policy, quanta(stem_ch, (1,)))
    if p_widths == tuple(widths) and p_stem == stem_ch:
        return model
    return model.clone(widths=p_widths, stem_width=p_stem,
                       logical_widths=tuple(widths), logical_stem=stem_ch)


def _cnn_original_twin(model, policy: LayoutPolicy, sample_x):
    c1, c2 = model.widths or (32, 64)
    p1, p2 = pad_channels(c1, policy), pad_channels(c2, policy)
    if (p1, p2) == (c1, c2):
        return model
    twin = model.clone(widths=(p1, p2))
    # The flatten boundary: Dense_0's input dim interleaves (h, w, c), so
    # a tail pad would bind logical weights to the wrong physical inputs;
    # pad and slice the channel axis through a reshape instead.
    h, w = sample_x.shape[1], sample_x.shape[2]
    if model.stem == "s2d":
        h, w = h // 2, w // 2
    h, w = h // 4, w // 4  # two 2x2 max-pools on SAME convs

    def pad_dense(leaf):
        k = leaf.reshape(*leaf.shape[:-1], h, w, c2)
        return F.pad(k, (0, p2 - c2)).reshape(*leaf.shape[:-1], h * w * p2)

    def unpad_dense(leaf):
        k = leaf.reshape(*leaf.shape[:-1], h, w, p2)[..., :c2]
        return k.reshape(*leaf.shape[:-1], h * w * c2)

    return twin, {"Dense_0.weight": (pad_dense, unpad_dense)}


def compute_layout(model, sample_x, *, lane: int = CARD_LANE,
                   sublane: int = CARD_SUBLANE, lane_snap: float = 0.25):
    """The padded :class:`ComputeLayout` of a supported model, or
    ``NotImplementedError`` naming the supported families. ``is_identity``
    when the policy pads nothing (the caller then skips the wrapper).
    ``sample_x``: one batched input (its shape: the flatten boundary's
    mapping depends on the feature maps). The defaults are the card's
    unit (``lane`` 64, ``sublane`` 8); ``lane=128, sublane=8`` gives JAX's
    physical shapes."""
    policy = LayoutPolicy(lane=lane, sublane=sublane, lane_snap=lane_snap)
    overrides: Dict[str, Tuple[Callable, Callable]] = {}
    if isinstance(model, CifarResNet):
        twin = _cifar_resnet_twin(model, policy)
    elif isinstance(model, CNNOriginalFedAvg):
        twin = _cnn_original_twin(model, policy, sample_x)
    elif isinstance(model, CNNDropOut):
        raise NotImplementedError(
            "compute_layout cannot pad dropout-bearing models: the mask "
            "draw shapes follow the PHYSICAL layout, so padded-vs-logical "
            "exactness is unattainable by construction (CNNDropOut; use "
            "CNNOriginalFedAvg or a GroupNorm conv net)")
    else:
        raise NotImplementedError(
            f"compute_layout has no physical-twin rule for "
            f"{type(model).__name__}; supported: CifarResNet (gn/bn/none"
            "), CNNOriginalFedAvg")
    if isinstance(twin, tuple):
        twin, overrides = twin
    layout = ComputeLayout(logical_model=model, physical_model=twin,
                           overrides=overrides)
    layout._build_specs()
    return layout


def step_dtype_model(model, dtype):
    """The compute-dtype twin of the bf16 client step
    (``cfg.client_step_dtype="bf16"``): ``model`` cloned with its layers
    computing in ``dtype``, the params (same names and shapes) f32, so the
    gradients, the optimizer, the aggregation and the eval stay f32.
    Refused for a family without a compute-dtype field."""
    if not isinstance(model, (CifarResNet, CNNOriginalFedAvg, CNNDropOut,
                              LogisticRegression)):
        raise NotImplementedError(
            f"client_step_dtype: {type(model).__name__} has no compute-"
            "dtype field; supported families expose `dtype` "
            "(CifarResNet, CNNOriginalFedAvg, CNNDropOut, "
            "LogisticRegression)")
    return model.clone(dtype=dtype)


def im2col_layout(model, sample_x):
    """A :class:`ComputeLayout` whose twin runs the CNN's 5×5 stem conv as
    patch extraction + a 1×1 conv (``CNNOriginalFedAvg(im2col=True)``):
    the contraction grows from Cin (1, or 4 under s2d) to 25·Cin. The
    weight maps by a reshape of the OIHW kernel (the patches' (c, kh, kw)
    order), exact both ways; the conv's 25-term sums may associate
    otherwise, so the step holds the CNN family's ~1-ulp tolerance.
    Widths are not padded here."""
    del sample_x
    if not isinstance(model, CNNOriginalFedAvg):
        raise NotImplementedError(
            f"im2col_layout has no stem-rephrasing twin for "
            f"{type(model).__name__}; supported: CNNOriginalFedAvg")
    if model.im2col:
        raise ValueError("model is already an im2col physical twin")
    cin = 4 if model.stem == "s2d" else 1

    def pad_stem(leaf):  # [..., c1, cin, 5, 5] -> [..., c1, cin·25, 1, 1]
        return leaf.reshape(*leaf.shape[:-3], cin * 25, 1, 1)

    def unpad_stem(leaf):
        return leaf.reshape(*leaf.shape[:-3], cin, 5, 5)

    layout = ComputeLayout(
        logical_model=model, physical_model=model.clone(im2col=True),
        overrides={"Conv_0.weight": (pad_stem, unpad_stem)})
    layout._build_specs()
    return layout


class _LayoutTrain:
    """A physical-model trainer behind the logical-shape contract of
    ``trainer.local.LocalTrain``: ``__call__`` (one client),
    ``run_clients`` (a cohort from one global net) and ``run_stacked`` (a
    cohort from per-client nets), each padding the nets it is given and
    slicing the logical block out of what it returns."""

    def __init__(self, inner, layout: ComputeLayout):
        self.inner, self.layout = inner, layout

    def __call__(self, net, x, y, mask, rng):
        phys, loss = self.inner(self.layout.pad(net), x, y, mask, rng)
        return self.layout.unpad(phys), loss

    def run_clients(self, net, x, y, mask, rngs):
        nets, losses = self.inner.run_clients(self.layout.pad(net), x, y,
                                              mask, rngs)
        return self.layout.unpad(nets), losses

    def run_stacked(self, nets, x, y, mask, rngs, anchor=None):
        if anchor is not None:
            anchor = self.layout.pad(NetState(anchor, {})).params
        out, losses = self.inner.run_stacked(self.layout.pad(nets), x, y,
                                             mask, rngs, anchor)
        return self.layout.unpad(out), losses


def wrap_local_train(local_train, layout: ComputeLayout):
    """A PHYSICAL-model trainer (a ``LocalTrain``) under the logical
    contract: ``wrapped(net, x, y, mask, rng) -> (net', loss)`` and the
    cohort methods, pad on entry and slice on exit — the only place the
    physical shapes exist."""
    return _LayoutTrain(local_train, layout)
