"""ResNet18* of arXiv:2003.03564 §V.A in plain PyTorch, and one client's
round of T-FedAvg (Algorithm 2) and FedAvg on it.

The network: a 3×3 stem conv to ``width`` channels, then 8 basic blocks at
``width`` channels whose first conv in blocks 2, 4 and 6 has stride 2 (the
shortcut a 2×2 max pool), GroupNorm(8) with eps 1e-5 in place of BatchNorm,
ReLU, a global mean pool and a dense head. Convs pad as XLA's "SAME"
(an odd pad after). Weights are HWIO, dense weights (in, out); inputs
(B, H, W, C).

Client training: E epochs of the given batches, Adam on every leaf. With
QAT (T-FedAvg) the loss is taken on the FTTQ-quantized weights (w_q · I_t,
one factor a kernel row of a conv, one for the head), the latent weights
take the straight-through gradient (times w_q where I_t ≠ 0) and each factor
steps by SGD, 0.05 · Σ g·I_t / (the leaf's size). The upload is the codes of
the trained weights by the mean rule with the trained factors; the server
folds the uploads' w_q · I_t into their sample-weighted mean and
re-quantizes it at the fixed Δ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import fttq

WQ_LR = 0.05


def init_params(m: dict, seed: int, device) -> dict:
    """The benchmark's draw, handed to the program and the reference alike:
    convs He-normal (std √(2 / (9·c_in))), the head Lecun-normal, norm
    scales one and biases zero, from one ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w, k, c = m["width"], 3, m["image_hw"][2]

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def conv(cin):
        return {"w": normal((k, k, cin, w), (2.0 / (k * k * cin)) ** 0.5)}

    def norm():
        return {"scale": torch.ones(w, device=device), "bias": torch.zeros(w, device=device)}

    params = {"stem": conv(c), "stem_norm": norm()}
    for b in range(m["blocks"]):
        params[f"block{b}"] = {"conv1": conv(w), "norm1": norm(), "conv2": conv(w),
                               "norm2": norm()}
    params["head"] = {"w": normal((w, m["n_classes"]), w ** -0.5),
                      "bias": torch.zeros(m["n_classes"], device=device)}
    return params


def _same(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad(x, k, stride, value=0.0):
    t, b = _same(x.shape[2], k, stride)
    left, right = _same(x.shape[3], k, stride)
    return F.pad(x, (left, right, t, b), value=value) if t or b or left or right else x


def _conv(x, w_hwio, stride=1):
    return F.conv2d(_pad(x, w_hwio.shape[0], stride), w_hwio.permute(3, 2, 0, 1), stride=stride)


def _gn(x, p):
    return F.group_norm(x, 8, p["scale"], p["bias"], eps=1e-5)


def forward(m: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(_gn(_conv(x.permute(0, 3, 1, 2), params["stem"]["w"]), params["stem_norm"]))
    for b in range(m["blocks"]):
        p = params[f"block{b}"]
        stride = 2 if b in m["downsample_blocks"] else 1
        y = torch.relu(_gn(_conv(h, p["conv1"]["w"], stride), p["norm1"]))
        y = _gn(_conv(y, p["conv2"]["w"]), p["norm2"])
        if stride != 1:
            h = F.max_pool2d(_pad(h, stride, stride, float("-inf")), stride, stride)
        h = torch.relu(h + y)
    return h.mean(dim=(2, 3)) @ params["head"]["w"] + params["head"]["bias"]


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        out.update(flatten(tree[k], path) if isinstance(tree[k], dict) else {path: tree[k]})
    return out


def unflatten(flat: dict) -> dict:
    root: dict = {}
    for path, v in flat.items():
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return root


def local_train(m: dict, start: dict, x: torch.Tensor, y: torch.Tensor, batches: list, *,
                qat: bool, t_k: float, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple[dict, dict]:
    """(trained flat params, trained flat factors) of one client from the
    flat ``start`` params over ``batches`` (index tensors into x, y)."""
    params = {p: v.detach().clone() for p, v in start.items()}
    factors = ({p: fttq.init_factor(v, t_k) for p, v in params.items()
                if fttq.quantized(p, v.shape)} if qat else {})
    mom = {p: torch.zeros_like(v) for p, v in params.items()}
    vel = {p: torch.zeros_like(v) for p, v in params.items()}
    for t, idx in enumerate(batches, start=1):
        leaves = {p: v.detach().clone().requires_grad_(True) for p, v in params.items()}
        used, all_codes = {}, {}
        for p, v in leaves.items():
            if p in factors:
                i_t = fttq.codes(fttq.rows_of(v.detach(), True), t_k).reshape(v.shape)
                all_codes[p] = i_t
                used[p] = (i_t * factors[p]).detach().requires_grad_(True)
            else:
                used[p] = v
        with torch.enable_grad():
            loss = F.cross_entropy(forward(m, unflatten(used), x[idx]), y[idx].long())
            grads = torch.autograd.grad(loss, list(used.values()))
        grads = dict(zip(used, grads))
        g_factor = {}
        for p, i_t in all_codes.items():
            g = grads[p]
            n = factors[p].numel()
            g_factor[p] = (g.reshape(n, -1) * i_t.reshape(n, -1)).sum(dim=1)
            f = factors[p].reshape((n,) + (1,) * (g.ndim - 1))
            grads[p] = torch.where(i_t != 0, g * f, g)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for p, g in grads.items():
            mom[p] = b1 * mom[p] + (1 - b1) * g
            vel[p] = b2 * vel[p] + (1 - b2) * g * g
            params[p] = params[p] - lr * (mom[p] / bc1) / ((vel[p] / bc2).sqrt() + eps)
        for p in factors:
            step = WQ_LR * g_factor[p] / float(params[p].numel())
            factors[p] = factors[p] - step.reshape(factors[p].shape)
    return params, factors


def upload(params: dict, factors: dict, t_k: float) -> dict:
    """{path: ("ternary", codes, factor) | ("raw", tensor)}: the codes of the
    trained weights by the mean rule, each with its trained factor."""
    out = {}
    for p, v in params.items():
        if p in factors:
            i_t = fttq.codes(fttq.rows_of(v, True), t_k).reshape(v.shape)
            out[p] = ("ternary", i_t, factors[p].reshape(-1))
        else:
            out[p] = ("raw", v)
    return out


def requantize(params: dict, *, t_k: float, delta: float) -> dict:
    """The server's broadcast: fixed Δ, the Prop-4.1 scale per row."""
    out = {}
    for p, v in params.items():
        if fttq.quantized(p, v.shape):
            i_t, scales = fttq.requantize(v, t_k=t_k, delta=delta)
            out[p] = ("ternary", i_t, scales)
        else:
            out[p] = ("raw", v)
    return out


def dense(payload: dict) -> dict:
    """The flat float32 params a payload stands for."""
    return {p: (fttq.dequantize(rec[1], rec[2], torch.float32) if rec[0] == "ternary"
                else rec[1].to(torch.float32)) for p, rec in payload.items()}


def fold(uploads: list, weights: list) -> dict:
    """Σ_k w_k · dense(upload_k) / Σ_k w_k, in float64, as float32."""
    total = float(sum(weights))
    out = {}
    for p in uploads[0]:
        acc = sum(float(w) * dense({p: u[p]})[p].double() for u, w in zip(uploads, weights))
        out[p] = (acc / total).to(torch.float32)
    return out
