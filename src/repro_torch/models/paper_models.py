"""The paper's own experimental models (§V.A), port of
``repro.models.paper_models``:

  - MLP 784-30-20-10 for MNIST (24,330 parameters: three bias-free weight
    matrices and a 10-unit output bias);
  - ResNet18*: 8 basic blocks with every conv at 64 channels, GroupNorm(8)
    for BatchNorm, a linear head (594,378 parameters at width 64).

Parameters are plain trees with the reference's keys and layouts — conv
weights HWIO, dense weights (in, out) — because the wire record shapes, the
per-leaf scales and the aggregation segments follow them; the conv call
permutes to PyTorch's OIHW. Activations run NCHW inside ``resnet_cifar``;
its input and output are the reference's (B, 32, 32, 3) → (B, 10).
Initializers draw from a CPU ``torch.Generator`` seeded with ``seed`` and
follow the reference's distributions, not its bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves


def param_count(params) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(params))


def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * std).to(device)


def _dense_init(gen, shape, device) -> torch.Tensor:
    """Lecun-normal with fan-in from axis −2 (``models.common.dense_init``)."""
    return _normal(gen, shape, 1.0 / shape[-2] ** 0.5, device)


# --------------------------------------------------------------------------
# MLP (MNIST).
# --------------------------------------------------------------------------


def init_mlp_mnist(seed: int = 0, in_dim: int = 784, hidden=(30, 20), n_classes: int = 10,
                   device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dims = (in_dim,) + tuple(hidden) + (n_classes,)
    params = {f"fc{i}": {"w": _dense_init(gen, (dims[i], dims[i + 1]), dev)}
              for i in range(len(dims) - 1)}
    params[f"fc{len(dims) - 2}"]["bias"] = torch.zeros((n_classes,), device=dev)
    return params


def mlp_mnist(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 784) → logits (B, 10)."""
    n = len(params)
    for i in range(n):
        p = params[f"fc{i}"]
        x = x @ p["w"]
        if "bias" in p:
            x = x + p["bias"]
        if i < n - 1:
            x = torch.relu(x)
    return x


# --------------------------------------------------------------------------
# ResNet18* (CIFAR10).
# --------------------------------------------------------------------------


def init_resnet_cifar(seed: int = 0, n_classes: int = 10, width: int = 64,
                      device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def conv(cin, cout):
        return _normal(gen, (3, 3, cin, cout), (2.0 / (9 * cin)) ** 0.5, dev)

    def norm():
        return {"scale": torch.ones((width,), device=dev),
                "bias": torch.zeros((width,), device=dev)}

    params: dict = {"stem": {"w": conv(3, width)}, "stem_norm": norm()}
    for b in range(8):  # 4 stages × 2 basic blocks, all at `width` channels
        params[f"block{b}"] = {"conv1": {"w": conv(width, width)}, "norm1": norm(),
                               "conv2": {"w": conv(width, width)}, "norm2": norm()}
    params["head"] = {"w": _dense_init(gen, (width, n_classes), dev),
                      "bias": torch.zeros((n_classes,), device=dev)}
    return params


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding (before, after) along one spatial axis: the
    output has ⌈size / stride⌉ positions and any odd pad goes AFTER, so a
    stride-2 3×3 conv on an even size pads 0 before and 1 after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    top, bottom = same_padding(x.shape[2], k, stride)
    left, right = same_padding(x.shape[3], k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW conv with an HWIO weight and XLA "SAME" padding."""
    x = _pad_same(x, w_hwio.shape[0], stride)
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride)


def _group_norm(x: torch.Tensor, p, groups: int = 8) -> torch.Tensor:
    """GroupNorm over contiguous channel groups, biased variance, eps 1e-5."""
    return F.group_norm(x, groups, p["scale"], p["bias"], eps=1e-5)


def _max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool2d(_pad_same(x, k, k, float("-inf")), k, k)


def resnet_cifar(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 32, 32, 3) → logits (B, 10)."""
    h = x.permute(0, 3, 1, 2)
    h = torch.relu(_group_norm(_conv(h, params["stem"]["w"]), params["stem_norm"]))
    for b in range(8):
        p = params[f"block{b}"]
        stride = 2 if b in (2, 4, 6) else 1  # downsample at stage starts
        y = _conv(h, p["conv1"]["w"], stride)
        y = torch.relu(_group_norm(y, p["norm1"]))
        y = _group_norm(_conv(y, p["conv2"]["w"]), p["norm2"])
        if stride != 1:
            h = _max_pool_same(h, stride)
        h = torch.relu(h + y)
    h = h.mean(dim=(2, 3))
    return h @ params["head"]["w"] + params["head"]["bias"]
