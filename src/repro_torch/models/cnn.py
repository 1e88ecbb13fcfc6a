"""The paper's simulation models (§V-A) as functional PyTorch models.

* ``MnistCNN`` — two 5x5 conv layers, 21,840 trainable parameters (conv
  1->10 (260) + conv 10->20 (5,020) + fc 320->50 (16,050) + fc 50->10 (510)).
* ``CifarCNN`` — six 3x3 conv layers and two fc layers, 2,205,258 parameters
  (16 leaves).

Parameters are plain dicts in the JAX package's layout — conv kernels HWIO,
fc weights ``(din, dout)``, inputs NHWC — so a JAX tree converts 1:1
(``repro_torch.convert``).  ``apply`` permutes to NCHW/OIHW for
``F.conv2d`` and back to NHWC before flattening, which keeps the flatten
order, and so the fc weights, identical.  Every function is written for
one client and is ``torch.func.vmap``-able over a stacked client axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["MnistCNN", "CifarCNN", "param_count"]


def param_count(params: dict) -> int:
    return sum(int(p.numel()) for p in params.values())


def _conv(x, w, b, padding=0):
    """NCHW activations, HWIO kernel."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=padding)


def _init_conv(gen, kh, kw, cin, cout):
    scale = (kh * kw * cin) ** -0.5
    return (
        torch.randn((kh, kw, cin, cout), generator=gen) * scale,
        torch.zeros((cout,)),
    )


def _init_fc(gen, din, dout):
    return torch.randn((din, dout), generator=gen) * din**-0.5, torch.zeros((dout,))


def _nll(logits, y):
    # labels arrive as int32 from the numpy data path; gather wants int64
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y.long()[:, None]).mean()


class _Classifier:
    num_classes = 10

    def apply(self, params, x):
        raise NotImplementedError

    def loss(self, params, batch):
        return _nll(self.apply(params, batch["x"]), batch["y"])

    def accuracy(self, params, batch):
        logits = self.apply(params, batch["x"])
        return (logits.argmax(-1) == batch["y"].long()).float().mean()


class MnistCNN(_Classifier):
    """Input (B, 28, 28, 1); 10 classes; 21,840 params."""

    def init(self, gen: torch.Generator) -> dict:
        w1, b1 = _init_conv(gen, 5, 5, 1, 10)
        w2, b2 = _init_conv(gen, 5, 5, 10, 20)
        w3, b3 = _init_fc(gen, 320, 50)
        w4, b4 = _init_fc(gen, 50, 10)
        return {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3, "w4": w4, "b4": b4}

    def apply(self, params, x):
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(_conv(x, params["w1"], params["b1"])), 2)  # 24->12
        x = F.max_pool2d(F.relu(_conv(x, params["w2"], params["b2"])), 2)  # 8->4
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten: 320
        x = F.relu(x @ params["w3"] + params["b3"])
        return x @ params["w4"] + params["b4"]


class CifarCNN(_Classifier):
    """Input (B, 32, 32, 3); six conv layers; 2,205,258 params."""

    def init(self, gen: torch.Generator) -> dict:
        p = {}
        specs = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256)]
        for i, (cin, cout) in enumerate(specs):
            p[f"cw{i}"], p[f"cb{i}"] = _init_conv(gen, 3, 3, cin, cout)
        p["fw0"], p["fb0"] = _init_fc(gen, 256 * 2 * 2, 1024)
        p["fw1"], p["fb1"] = _init_fc(gen, 1024, 10)
        return p

    def apply(self, params, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(6):
            # 3x3 SAME convolution == padding 1
            x = F.relu(_conv(x, params[f"cw{i}"], params[f"cb{i}"], padding=1))
            if i % 2 == 1:
                x = F.max_pool2d(x, 2)  # 32->16->8->4
        x = F.max_pool2d(x, 2)  # 4 -> 2
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # 2*2*256 = 1024
        x = F.relu(x @ params["fw0"] + params["fb0"])
        return x @ params["fw1"] + params["fb1"]
