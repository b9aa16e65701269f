"""The federated language models (port of ``fedml_tpu/models/rnn.py``):

- :class:`RNNOriginalFedAvg`: McMahan'17's Shakespeare char-LM, embedding
  (vocab 90 → 8), two LSTM(256), a dense to the vocab (``"rnn"``);
- :class:`RNNStackOverflow`: Reddi'20's next-word model, embedding (vocab
  10004 → 96), one LSTM(670), a dense to 96 and one to the vocab
  (``"rnn_stackoverflow"``).

Inputs are int token ids ``[B, T]``; outputs the logits ``[B, T, vocab]``
at every position, for ``trainer.local.seq_softmax_ce``.

:class:`LSTM` is flax's ``nn.RNN(nn.OptimizedLSTMCell(H))`` in torch ops:
the same parameters (``ii``/``if``/``ig``/``io`` input kernels without
bias, ``hi``/``hf``/``hg``/``ho`` recurrent kernels with bias; ``Dense``
layout, so ``convert.from_jax_params`` transposes them as it does a
``Dense``), the same gate order (i, f, g, o), a zero carry, and
``c' = f·c + i·g``, ``h' = o·tanh(c')``. The input projections of all T
positions are one matmul; the recurrence is one step per position. It is
not ``nn.LSTM``: cuDNN's RNN does not batch under ``vmap`` over stacked
client params, and its weights are another layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.cnn import dense
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import _lecun_normal_

_GATES = "ifgo"


class _DenseParams(nn.Module):
    """One gate's kernel (``weight [out, in]``), with a bias or none."""

    def __init__(self, cin, cout, bias, generator, orthogonal=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        if orthogonal:  # flax's recurrent_kernel_init
            with torch.no_grad():
                nn.init.orthogonal_(self.weight, generator=generator)
        else:
            _lecun_normal_(self.weight, cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class LSTM(nn.Module):
    """One flax ``OptimizedLSTMCell`` run over the sequence: ``[B, T, in]``
    → ``[B, T, H]``."""

    def __init__(self, cin, hidden, generator=None):
        super().__init__()
        self.hidden = hidden
        for g in _GATES:
            self.add_module(f"i{g}", _DenseParams(cin, hidden, False,
                                                  generator))
        for g in _GATES:
            self.add_module(f"h{g}", _DenseParams(hidden, hidden, True,
                                                  generator, orthogonal=True))

    def forward(self, x):
        gate = [getattr(self, f"i{g}") for g in _GATES]
        rec = [getattr(self, f"h{g}") for g in _GATES]
        w_i = torch.cat([m.weight for m in gate])  # [4H, in]
        w_h = torch.cat([m.weight for m in rec])  # [4H, H]
        b_h = torch.cat([m.bias for m in rec])
        b, t, h_dim = x.shape[0], x.shape[1], self.hidden
        xi = F.linear(x, w_i)  # every position's input projections
        c = h = x.new_zeros(b, h_dim)
        outs = []
        for s in range(t):
            z = F.linear(h, w_h, b_h) + xi[:, s]
            sig = torch.sigmoid(z)  # i, f and o; g's slice unused
            i, f, o = (sig[:, :h_dim], sig[:, h_dim:2 * h_dim],
                       sig[:, 3 * h_dim:])
            g = torch.tanh(z[:, 2 * h_dim:3 * h_dim])
            c = f * c + i * g
            h = o * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


def _embed(vocab, features, generator):
    """flax ``nn.Embed``: ``weight [vocab, features]``, variance 1/features
    as flax's default ``variance_scaling`` draws it (truncated normal)."""
    layer = nn.Embedding(vocab, features)
    _lecun_normal_(layer.weight, features, generator)
    return layer


class RNNOriginalFedAvg(nn.Module):
    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8,
                 hidden_size: int = 256, generator=None):
        super().__init__()
        self.Embed_0 = _embed(vocab_size, embedding_dim, generator)
        self.OptimizedLSTMCell_0 = LSTM(embedding_dim, hidden_size, generator)
        self.OptimizedLSTMCell_1 = LSTM(hidden_size, hidden_size, generator)
        self.Dense_0 = dense(hidden_size, vocab_size, generator)

    def forward(self, x):  # x [B, T] ids
        h = self.OptimizedLSTMCell_0(self.Embed_0(x.long()))
        h = self.OptimizedLSTMCell_1(h)
        return self.Dense_0(h)


class RNNStackOverflow(nn.Module):
    def __init__(self, vocab_size: int = 10004, embedding_dim: int = 96,
                 hidden_size: int = 670, generator=None):
        super().__init__()
        self.Embed_0 = _embed(vocab_size, embedding_dim, generator)
        self.OptimizedLSTMCell_0 = LSTM(embedding_dim, hidden_size, generator)
        self.Dense_0 = dense(hidden_size, embedding_dim, generator)
        self.Dense_1 = dense(embedding_dim, vocab_size, generator)

    def forward(self, x):  # x [B, T] ids
        h = self.OptimizedLSTMCell_0(self.Embed_0(x.long()))
        return self.Dense_1(self.Dense_0(h))


@register_model("rnn")
def rnn(vocab_size: int = 90, device=None, generator=None, **_):
    return RNNOriginalFedAvg(vocab_size=vocab_size,
                             generator=generator).to(resolve_device(device))


@register_model("rnn_stackoverflow")
def rnn_stackoverflow(vocab_size: int = 10004, device=None, generator=None,
                      **_):
    return RNNStackOverflow(vocab_size=vocab_size,
                            generator=generator).to(resolve_device(device))
