"""ResNet-18 (CIFAR variant), the paper's §3.1.3 regime (port of
``repro/models/resnet.py``).

The paper's most compressible setting: high SNR across fan_in and fan_out
almost everywhere (Fig. 5), the first conv resisting fan_out compression and
the classifier near SNR ~ 1 (``benchmarks/resnet_snr.py``).

Conv kernels are stored (kh, kw, cin, cout) with fan_in = (kh, kw, cin), as
the JAX package stores them, so rules, reduced-moment shapes and megaplan
groups match; the forward permutes them for ``F.conv2d`` and runs in NCHW.
Convolutions pad as XLA's ``SAME`` does: at stride 2 on an even input that
is 0 before and 1 after, not ``padding=1`` on both sides. BatchNorm uses
per-batch statistics (training mode; running stats are irrelevant to the
SNR study).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .common import ParamModel, ParamSpec, init_params, meta_tree, normal_init, ones_init, zeros_init


def _he_init(gen, shape, dtype):
    std = (2.0 / math.prod(shape[:3])) ** 0.5
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


def _conv_spec(kh, kw, cin, cout, role="conv"):
    return ParamSpec((kh, kw, cin, cout), ("kh", "kw", "cin", "cout"), role, _he_init,
                     fan_in=("kh", "kw", "cin"), fan_out=("cout",))


def _bn_specs(c):
    return {
        "scale": ParamSpec((c,), ("cout",), "norm", ones_init()),
        "bias": ParamSpec((c,), ("cout",), "bias", zeros_init()),
    }


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stages: Tuple[int, ...] = (2, 2, 2, 2)   # ResNet-18
    width: int = 64
    classes: int = 100
    in_channels: int = 3

    def specs(self) -> Dict[str, Any]:
        w = self.width
        specs: Dict[str, Any] = {
            "stem": {"conv": _conv_spec(3, 3, self.in_channels, w), "bn": _bn_specs(w)},
        }
        cin = w
        for si, n_blocks in enumerate(self.stages):
            cout = w * (2 ** si)
            for bi in range(n_blocks):
                block: Dict[str, Any] = {
                    "conv1": _conv_spec(3, 3, cin, cout), "bn1": _bn_specs(cout),
                    "conv2": _conv_spec(3, 3, cout, cout), "bn2": _bn_specs(cout),
                }
                if cin != cout:
                    block["proj"] = _conv_spec(1, 1, cin, cout)
                specs[f"stage{si}_block{bi}"] = block
                cin = cout
        specs["head"] = ParamSpec((cin, self.classes), ("cin", "vocab"), "head",
                                  normal_init(0.01), fan_in=("cin",), fan_out=("vocab",))
        return specs

    def init(self, gen: torch.Generator, device):
        spec = self.specs()
        return init_params(spec, gen, device), meta_tree(spec)


def _same_pads(hw, kernel, stride: int):
    """F.pad's (left, right, top, bottom) for XLA's SAME padding: the total
    is what ceil(n / stride) outputs need, the odd pixel after."""
    pads = []
    for n, k in zip(reversed(hw), reversed(kernel)):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _conv(x, w, stride: int = 1):
    """x (B, C, H, W) by a (kh, kw, cin, cout) kernel, SAME padding."""
    pads = _same_pads(x.shape[2:], w.shape[:2], stride)
    if any(pads):
        x = F.pad(x, pads)
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _bn(x, scale, bias, eps: float = 1e-5):
    mean = torch.mean(x, dim=(0, 2, 3), keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=(0, 2, 3), keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * scale[None, :, None, None] + bias[None, :, None, None]


def forward(cfg: ResNetConfig, params, batch):
    """batch['images']: (B, H, W, C) -> (logits (B, classes), aux = 0)."""
    def bn(x, name):
        return _bn(x, params[f"{name}.scale"], params[f"{name}.bias"])

    x = batch["images"].permute(0, 3, 1, 2)
    x = torch.relu(bn(_conv(x, params["stem.conv"]), "stem.bn"))
    for si, n_blocks in enumerate(cfg.stages):
        for bi in range(n_blocks):
            b = f"stage{si}_block{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            h = torch.relu(bn(_conv(x, params[f"{b}.conv1"], stride), f"{b}.bn1"))
            h = bn(_conv(h, params[f"{b}.conv2"]), f"{b}.bn2")
            skip = _conv(x, params[f"{b}.proj"], stride) if f"{b}.proj" in params else x
            x = torch.relu(h + skip)
    x = torch.mean(x, dim=(2, 3))                 # global average pool
    return x @ params["head"], torch.zeros((), dtype=torch.float32, device=x.device)


class ResNet(ParamModel):
    """ResNet's parameters as an ``nn.Module`` (see
    :class:`repro_torch.models.common.ParamModel`)."""

    def forward(self, batch):
        return forward(self.cfg, self.params, batch)


def synthetic_cifar(gen: torch.Generator, batch: int, classes: int, size: int = 32):
    """Learnable synthetic images on ``gen``'s device: class-dependent
    channel means (drawn from seed 7) plus noise. JAX's draws are not
    reproduced; the distribution is the same."""
    labels = torch.randint(0, classes, (batch,), generator=gen, device=gen.device)
    means = torch.randn((classes, 3), generator=torch.Generator(device=gen.device).manual_seed(7),
                        device=gen.device) * 0.5
    imgs = torch.randn((batch, size, size, 3), generator=gen, device=gen.device) * 0.3 + means[labels][:, None, None, :]
    return {"images": imgs, "labels": labels}
