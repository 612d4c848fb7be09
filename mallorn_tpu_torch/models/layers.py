"""The ``flax.linen`` layers the DL models are built from, as torch modules.

Every parameter keeps flax's name and layout, so a module's
``state_dict`` key is the flax parameter path with ``.`` for ``/``
(``EncoderBlock_0.MultiHeadDotProductAttention_0.query.kernel`` is flax's
``EncoderBlock_0/MultiHeadDotProductAttention_0/query/kernel``):
``state_from_flax`` carries a flax parameter tree into any of the
port's models and ``state_to_flax`` writes one back, with no per-model
table. Where torch's own layer computes something else, the flax
arithmetic is written out:

- ``Dense`` keeps ``kernel`` as ``[in, out]`` (``nn.Linear.weight`` is
  its transpose);
- ``LayerNorm`` takes epsilon 1e-6 and the variance as E[x^2] - E[x]^2;
- ``gelu`` is the tanh approximation;
- ``MultiHeadDotProductAttention`` has ``[D, H, Dh]`` query, key and
  value kernels and an ``[H, Dh, D]`` output kernel, divides the query by
  sqrt(Dh) and gives masked logits ``finfo(float32).min`` (a row with no
  valid key gets uniform weights, not NaN); its attention-weight dropout
  draws one ``[Tq, Tk]`` mask for the whole batch and every head;
- ``dropout`` draws its keep mask from an explicit ``torch.Generator``
  (``None``: the device's default generator).

Initialisation follows flax's defaults (``init_params``): Dense and
DenseGeneral kernels LeCun normal (truncated at two standard deviations),
recurrent kernels orthogonal, embeddings variance-scaled on the feature
width, learned tokens normal(0.02), biases zero, LayerNorm scales one. It
draws from a CPU generator, so a seed gives the same weights on every
device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
MASKED_LOGIT = float(torch.finfo(torch.float32).min)


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)


class Dense(nn.Module):
    """``flax.linen.Dense``: ``x @ kernel + bias``, kernel ``[in, out]``;
    ``recurrent`` initialises the kernel orthogonally (an RNN cell's
    hidden-side kernels)."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool = True,
                 recurrent: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.empty(d_out)) if use_bias else None
        self.recurrent = recurrent

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.recurrent:
            nn.init.orthogonal_(self.kernel, generator=gen)
        else:
            _lecun_normal_(self.kernel, self.kernel.shape[0], gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class DenseGeneral(nn.Module):
    """The kernel and bias of one of flax's attention projections:
    ``kernel`` ``in_shape + out_shape``, ``bias`` ``out_shape``; the
    attention does the contraction itself."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int]):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.empty(*out_shape))
        self.fan_in = math.prod(in_shape)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _lecun_normal_(self.kernel, self.fan_in, gen)
        nn.init.zeros_(self.bias)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis (epsilon 1e-6, fast
    variance)."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + LN_EPS) * self.scale) + self.bias


class Embed(nn.Module):
    """``flax.linen.Embed``: rows of ``embedding`` ``[n, d]``."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n, d))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _lecun_normal_(self.embedding, self.embedding.shape[1], gen)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        # F.embedding's backward reduces each row's gradient by segments;
        # advanced indexing's (index_put_ accumulate) runs one row's
        # hundreds of thousands of duplicates nearly serially
        return F.embedding(idx.long(), self.embedding)


def token(*shape: int) -> nn.Parameter:
    """A learned token or per-feature table, initialised normal(0.02) by
    ``init_params`` (flax's ``self.param(..., normal(0.02), shape)``)."""
    p = nn.Parameter(torch.empty(*shape))
    p.flax_normal = True
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator], shape=None) -> torch.Tensor:
    """``flax.linen.Dropout``: keep with probability 1 - rate, kept values
    scaled by 1 / (1 - rate); ``shape`` (broadcast to ``x``) defaults to
    ``x``'s. The identity outside training or at rate 0."""
    if not training or rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape if shape is None else shape, generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class MultiHeadDotProductAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` as self-attention, with
    explicit products and a softmax; ``mask`` [N, T] marks the valid
    keys."""

    def __init__(self, d: int, n_heads: int, dropout_rate: float):
        super().__init__()
        dh = d // n_heads
        self.query = DenseGeneral((d,), (n_heads, dh))
        self.key = DenseGeneral((d,), (n_heads, dh))
        self.value = DenseGeneral((d,), (n_heads, dh))
        self.out = DenseGeneral((n_heads, dh), (d,))
        self.dropout_rate = dropout_rate
        self.head_dim = dh

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def project(p):
            return torch.einsum("ntd,dhk->nthk", x, p.kernel) + p.bias

        q = project(self.query) / math.sqrt(self.head_dim)
        k, v = project(self.key), project(self.value)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k)
        logits = torch.where(mask[:, None, None, :], logits, MASKED_LOGIT)
        w = torch.softmax(logits, dim=-1)
        tq, tk = w.shape[-2:]
        w = dropout(w, self.dropout_rate, self.training, generator, shape=(1, 1, tq, tk))
        y = torch.einsum("nhqk,nkhd->nqhd", w, v)
        return torch.einsum("nqhd,hdo->nqo", y, self.out.kernel) + self.out.bias


def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Flax's default initialisation of every parameter of ``module`` from
    one CPU generator seeded ``seed``; returns ``module``."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            for p in m.parameters(recurse=False):
                if getattr(p, "flax_normal", False):
                    nn.init.normal_(p, std=0.02, generator=gen)
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
    return module


def flatten_flax(params: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested flax variables tree -> {``"params/Dense_0/kernel"``: array}
    (``flax.traverse_util.flatten_dict`` joined with ``/``)."""
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update(flatten_flax(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = np.asarray(v)
    return flat


def state_from_flax(params) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (``{"params": {...}}`` or its contents),
    nested or flattened to ``"/"``-joined keys, as arrays -> the state dict
    of the port's module of the same model
    (``module.load_state_dict(state_from_flax(params))``)."""
    if any(isinstance(v, dict) for v in params.values()):
        params = flatten_flax(params)
    return {k.removeprefix("params/").replace("/", "."): torch.from_numpy(np.array(v, np.float32))
            for k, v in params.items()}


def state_to_flax(module: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse: {``"params/Dense_0/kernel"``: float32 array} of
    ``module``, the flattened flax variables tree (``save_pretrained``'s
    keys)."""
    return {"params/" + k.replace(".", "/"): v.detach().cpu().numpy()
            for k, v in module.state_dict().items()}
