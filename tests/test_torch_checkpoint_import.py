"""Reference torch checkpoints into the port (``models/torch_convert.py``):
a torch CIFAR ResNet in the reference's architecture and the GKT client
stump and server tail, with random weights and running stats from a seed,
are saved as state dicts (the reference's ``{'state_dict': ...}`` format
with DataParallel's ``module.`` prefix, and bare); the port loads them
into ``CifarResNet(norm="bn")`` and the split pair and reproduces their
eval-mode outputs. The refusals: a deeper checkpoint, a missing tensor, a
shape mismatch, the s2d stem, a wrong role."""

import numpy as np
import pytest
import torch
import torch.nn as tnn

from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.models.resnet_split import (ResNetClientStump,
                                                 ResNetServerTail)
from fedml_tpu_torch.models.torch_convert import (convert_torch_cifar_resnet,
                                                  convert_torch_gkt_client,
                                                  convert_torch_gkt_server,
                                                  load_torch_checkpoint,
                                                  load_torch_gkt_checkpoint)
from fedml_tpu_torch.trainer.local import model_fns

# Eval-mode outputs within 1e-5 of their scale (f32; the same convs in
# torch's NCHW against the port's channels-last layout).
TOL = 1e-5


class _Bottleneck(tnn.Module):
    def __init__(self, inp, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = tnn.Conv2d(inp, planes, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + idn)


class _Basic(tnn.Module):
    def __init__(self, inp, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = tnn.Conv2d(inp, planes, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + idn)


def _stages(owner, layers, inp=16):
    for s, (planes, n) in enumerate(zip((16, 32, 64), layers)):
        blocks = []
        for i in range(n):
            stride = 2 if (s > 0 and i == 0) else 1
            down = None
            if stride != 1 or inp != planes * 4:
                down = tnn.Sequential(
                    tnn.Conv2d(inp, planes * 4, 1, stride, bias=False),
                    tnn.BatchNorm2d(planes * 4))
            blocks.append(_Bottleneck(inp, planes, stride, down))
            inp = planes * 4
        setattr(owner, f"layer{s + 1}", tnn.Sequential(*blocks))


class _TorchCifarResNet(tnn.Module):
    """The reference's CIFAR bottleneck ResNet (model/cv/resnet.py)."""

    def __init__(self, layers):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 16, 3, 1, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(16)
        _stages(self, layers)
        self.fc = tnn.Linear(256, 10)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.fc(x.mean(dim=(2, 3)))


class _TorchGKTClient(tnn.Module):
    """The reference GKT stump: the stem and ``layer1`` of 16 planes, its
    own ``fc``; returns (logits, the stem's features)."""

    def __init__(self, n_blocks, bottleneck):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 16, 3, 1, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(16)
        exp, inp, blocks = (4 if bottleneck else 1), 16, []
        for _ in range(n_blocks):
            down = None
            if inp != 16 * exp:
                down = tnn.Sequential(tnn.Conv2d(inp, 16 * exp, 1, 1,
                                                 bias=False),
                                      tnn.BatchNorm2d(16 * exp))
            blocks.append((_Bottleneck if bottleneck else _Basic)(
                inp, 16, 1, down))
            inp = 16 * exp
        self.layer1 = tnn.Sequential(*blocks)
        self.fc = tnn.Linear(16 * exp, 10)

    def forward(self, x):
        feats = torch.relu(self.bn1(self.conv1(x)))
        return self.fc(self.layer1(feats).mean(dim=(2, 3))), feats


class _TorchGKTServer(tnn.Module):
    """The reference GKT tail: a stem its forward never runs, then three
    stages on the client's 16-channel features."""

    def __init__(self, layers):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 16, 3, 1, 1, bias=False)  # unused
        self.bn1 = tnn.BatchNorm2d(16)  # unused
        _stages(self, layers)
        self.fc = tnn.Linear(256, 10)

    def forward(self, feats):
        x = self.layer3(self.layer2(self.layer1(feats)))
        return self.fc(x.mean(dim=(2, 3)))


def _randomized(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in model.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=g) * 0.05)
                m.running_var.copy_(1 + 0.1 * torch.rand(
                    m.running_var.shape, generator=g))
    return model.eval()


def _images(n, c=3, seed=0):
    return torch.tensor(np.random.RandomState(seed).randn(n, 16, 16, c)
                        .astype(np.float32))


def _close(got, want):
    tol = TOL * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


LAYERS = (2, 2, 2)


@pytest.mark.parametrize("wrapped", [True, False])
def test_cifar_resnet_checkpoint_reproduces_torch(tmp_path, wrapped):
    """A saved checkpoint (the ``{'state_dict'}`` wrapper with ``module.``
    prefixes, or a bare state dict) loaded through
    ``load_torch_checkpoint``: the port's eval logits are the torch
    model's."""
    tm = _randomized(_TorchCifarResNet(LAYERS), seed=1)
    sd = tm.state_dict()
    path = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}
               if wrapped else sd, path)
    fns = model_fns(CifarResNet(layers=LAYERS, norm="bn"))
    net = load_torch_checkpoint(path, fns.init(), layers=LAYERS)
    assert torch.equal(net.model_state["Norm_0.BatchNorm_0.var"],
                       sd["bn1.running_var"])
    x = _images(3)
    with torch.no_grad():
        want = tm(x.permute(0, 3, 1, 2))
        got, _ = fns.apply(net, x, train=False)
    _close(got, want)


@pytest.mark.parametrize("n_blocks,bottleneck", [(1, False), (2, True)])
def test_gkt_client_checkpoint_reproduces_torch(tmp_path, n_blocks,
                                                bottleneck):
    """The stump (``resnet5_56``: one basic block; ``resnet8_56``: two
    bottlenecks) from a saved checkpoint: logits and features."""
    tm = _randomized(_TorchGKTClient(n_blocks, bottleneck), seed=2)
    path = str(tmp_path / "client.pth")
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in tm.state_dict().items()}}, path)
    fns = model_fns(ResNetClientStump(
        n_blocks, "bottleneck" if bottleneck else "basic", norm="bn"))
    net = load_torch_gkt_checkpoint(path, fns.init(), role="client",
                                    n_blocks=n_blocks)
    x = _images(2, seed=3)
    with torch.no_grad():
        want_logits, want_feats = tm(x.permute(0, 3, 1, 2))
        (logits, feats), _ = fns.apply(net, x, train=False)
    _close(logits, want_logits)
    _close(feats, want_feats)


def test_gkt_server_checkpoint_drops_the_unused_stem():
    tm = _randomized(_TorchGKTServer(LAYERS), seed=4)
    fns = model_fns(ResNetServerTail(LAYERS, "bottleneck", norm="bn"))
    sd = {f"module.{k}": v for k, v in tm.state_dict().items()}
    net = convert_torch_gkt_server(sd, fns.init(), layers=LAYERS)
    feats = _images(2, c=16, seed=5).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = tm(feats)
        got, _ = fns.apply(net, feats, train=False)
    _close(got, want)


def test_refusals():
    """A deeper checkpoint leaves tensors unused; a missing tensor and a
    shape mismatch are named; the s2d stem has no reference checkpoint;
    the GKT loader takes 'client' or 'server' only."""
    sd = _randomized(_TorchCifarResNet((3, 3, 3))).state_dict()
    net = model_fns(CifarResNet(layers=LAYERS, norm="bn")).init()
    with pytest.raises(ValueError, match="unused tensors"):
        convert_torch_cifar_resnet(sd, net, layers=LAYERS)
    small = _randomized(_TorchCifarResNet(LAYERS)).state_dict()
    missing = {k: v for k, v in small.items() if k != "fc.bias"}
    with pytest.raises(KeyError, match="fc.bias"):
        convert_torch_cifar_resnet(missing, net, layers=LAYERS)
    bad = dict(small, **{"fc.weight": torch.zeros(10, 3)})
    with pytest.raises(ValueError, match="shape"):
        convert_torch_cifar_resnet(bad, net, layers=LAYERS)
    s2d = model_fns(CifarResNet(layers=LAYERS, norm="bn", stem="s2d")).init()
    with pytest.raises(ValueError, match="cannot map onto the reference"):
        convert_torch_cifar_resnet(small, s2d, layers=LAYERS)
    with pytest.raises(ValueError, match="role"):
        load_torch_gkt_checkpoint("unused.pth", net, role="tail")
    stump = model_fns(ResNetClientStump(1, "basic", norm="bn")).init()
    client = _randomized(_TorchGKTClient(1, False)).state_dict()
    assert convert_torch_gkt_client(client, stump).params.keys() == \
        stump.params.keys()
