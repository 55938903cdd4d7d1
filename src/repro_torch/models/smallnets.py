"""Small classifiers for the paper's experiments
(``repro.models.smallnets``): MLP (tabular) and the paper's CNN (two 5x5
convs 6/16 ch + 2x2 pools + FC 120/84), plus a VGG-9-lite for the
CelebA-style task.

Interface: init(key, device) -> params; apply(params, X) -> logits.

Parameters keep the reference's tree, so ``convert`` carries them both
ways unchanged and a wire update's header (paths, shapes, dtypes, key
order) is the reference's: dense ``w`` is (nin, nout), conv ``w`` is
HWIO, everything float32, and each layer's dict holds "b" before "w"
(the order in which the reference's dicts leave ``jax.jit``).  Images
are NHWC, as in the reference; the convolutions run in NCHW and the
activations go back to NHWC before the flatten, so ``f1``'s rows keep
the reference's (H, W, C) order.  Init draws on the host through
``prng`` (``normal`` within 2.5e-7 of ``jax.random.normal``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch.nn.functional as F

from repro_torch import device as D
from repro_torch import prng


def _dense(key, nin, nout):
    k1, _ = prng.split(key)
    return {"b": np.zeros((nout,), np.float32),
            "w": prng.normal(k1, (nin, nout)) * np.float32(nin ** -0.5)}


def _conv(key, kh, kw, cin, cout):
    k1, _ = prng.split(key)
    fan = kh * kw * cin
    return {"b": np.zeros((cout,), np.float32),
            "w": prng.normal(k1, (kh, kw, cin, cout))
            * np.float32(fan ** -0.5)}


def _linear(p, h):
    return h @ p["w"] + p["b"]


def _conv2d(p, x, padding=0):
    """NCHW activations, the HWIO kernel permuted to OIHW."""
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"],
                    padding=padding)


def _flatten_nhwc(h):
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


@dataclass(frozen=True)
class MLP:
    """Tabular classifier: features -> hidden -> hidden -> classes."""
    num_features: int
    num_classes: int
    hidden: int = 64

    def init(self, key, device=D.DEFAULT):
        k1, k2, k3 = prng.split(key, 3)
        return D.put({"l1": _dense(k1, self.num_features, self.hidden),
                      "l2": _dense(k2, self.hidden, self.hidden),
                      "l3": _dense(k3, self.hidden, self.num_classes)},
                     device)

    def apply(self, p, x):
        h = F.relu(_linear(p["l1"], x))
        h = F.relu(_linear(p["l2"], h))
        return _linear(p["l3"], h)


@dataclass(frozen=True)
class PaperCNN:
    """The paper's MNIST/SVHN CNN (LeNet-style, §5)."""
    image_size: int = 28
    channels: int = 1
    num_classes: int = 10

    def init(self, key, device=D.DEFAULT):
        ks = prng.split(key, 5)
        s = self.image_size
        s = (s - 4) // 2          # conv5 + pool
        s = (s - 4) // 2          # conv5 + pool
        return D.put({"c1": _conv(ks[0], 5, 5, self.channels, 6),
                      "c2": _conv(ks[1], 5, 5, 6, 16),
                      "f1": _dense(ks[2], s * s * 16, 120),
                      "f2": _dense(ks[3], 120, 84),
                      "f3": _dense(ks[4], 84, self.num_classes)}, device)

    def apply(self, p, x):
        # x: (B, H, W, C) float32
        h = x.permute(0, 3, 1, 2)
        h = F.max_pool2d(F.relu(_conv2d(p["c1"], h)), 2)
        h = F.max_pool2d(F.relu(_conv2d(p["c2"], h)), 2)
        h = _flatten_nhwc(h)
        h = F.relu(_linear(p["f1"], h))
        h = F.relu(_linear(p["f2"], h))
        return _linear(p["f3"], h)


@dataclass(frozen=True)
class VGG9Lite:
    """Thin VGG-9 (appendix Table 12 structure, reduced widths for CPU)."""
    image_size: int = 32
    channels: int = 3
    num_classes: int = 2
    width: int = 16

    def init(self, key, device=D.DEFAULT):
        w = self.width
        ks = prng.split(key, 9)
        s = self.image_size // 8
        return D.put({
            "c1": _conv(ks[0], 3, 3, self.channels, w),
            "c2": _conv(ks[1], 3, 3, w, 2 * w),
            "c3": _conv(ks[2], 3, 3, 2 * w, 4 * w),
            "c4": _conv(ks[3], 3, 3, 4 * w, 4 * w),
            "c5": _conv(ks[4], 3, 3, 4 * w, 8 * w),
            "c6": _conv(ks[5], 3, 3, 8 * w, 8 * w),
            "f1": _dense(ks[6], s * s * 8 * w, 128),
            "f2": _dense(ks[7], 128, 128),
            "f3": _dense(ks[8], 128, self.num_classes),
        }, device)

    def apply(self, p, x):
        # "SAME" 3x3 convolutions at stride 1: one pixel of zero padding
        h = x.permute(0, 3, 1, 2)
        h = F.relu(_conv2d(p["c1"], h, 1))
        h = F.max_pool2d(F.relu(_conv2d(p["c2"], h, 1)), 2)
        h = F.relu(_conv2d(p["c3"], h, 1))
        h = F.max_pool2d(F.relu(_conv2d(p["c4"], h, 1)), 2)
        h = F.relu(_conv2d(p["c5"], h, 1))
        h = F.max_pool2d(F.relu(_conv2d(p["c6"], h, 1)), 2)
        h = _flatten_nhwc(h)
        h = F.relu(_linear(p["f1"], h))
        h = F.relu(_linear(p["f2"], h))
        return _linear(p["f3"], h)
