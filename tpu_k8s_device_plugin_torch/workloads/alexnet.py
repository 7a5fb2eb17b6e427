"""AlexNet training in PyTorch: the port of the JAX package's
``workloads/alexnet.py``.

The canonical 5-conv / 3-dense single-tower AlexNet, NHWC throughout as
in the JAX package: every conv runs through ``F.conv2d`` on the NCHW
view ``x.permute(0, 3, 1, 2)`` of an NHWC tensor (channels-last strides,
so cuDNN keeps NHWC), and the flatten before ``Dense_0`` is in NHWC
order.  Parameters are f32 and cast to the compute dtype at each use;
images are cast at the top and the logits come back as f32.  Each
max-pool comes *before* the relu that follows it, as in the JAX model.

``pool`` chooses how the three conv->pool stages run:

- ``"xla"``: the conv, then ``F.max_pool2d`` (the library yardstick; the
  JAX package leaves this path to XLA);
- ``"pallas"``: the conv, then :func:`.pool.max_pool` (K1 forward, K2
  backward on CUDA);
- ``"fused"``: :class:`FusedConvPool` (K3 forward, K2 then the conv's
  own gradients backward); needs ``s2d``.

Parameter names are ``Conv_0..Conv_4`` and ``Dense_0..Dense_2`` under
every ``pool``; ``convert.alexnet_params_from_jax`` maps the JAX trees
onto them.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .convpool import POOL_STRIDE, POOL_WINDOW, conv_pool
from .pool import _out_dim, max_pool
from .transformer import _fill_, resolve_device

COMPUTE_DTYPE = torch.bfloat16

NUM_CLASSES = 1000
IMAGE_SIZE = 224

S2D_BLOCK = 4  # space-to-depth block == the raw first conv's stride

POOLS = ("xla", "pallas", "fused")


def space_to_depth(x: torch.Tensor, block: int = S2D_BLOCK) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C): fold b x b pixel blocks into
    channels, so the stride-4 11x11 first conv over 3 channels becomes a
    stride-1 3x3 conv over 48."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // block, w // block, block * block * c)


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """TF/flax SAME padding (before, after) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``nn.Conv(features, (window, window), strides, padding="SAME")``
    over NHWC: f32 ``weight [F, C, w, w]`` and ``bias [F]``, both cast to
    the input's dtype at use.  Left uninitialised: load it, or fill it."""

    def __init__(self, c_in: int, features: int, window: int,
                 stride: int = 1, device=None):
        super().__init__()
        self.window, self.stride = window, stride
        self.weight = nn.Parameter(torch.empty(
            features, c_in, window, window, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2)
        ph = _same_pads(x.shape[1], self.window, self.stride)
        pw = _same_pads(x.shape[2], self.window, self.stride)
        padding = ph[0]
        if ph != (padding, padding) or pw != (padding, padding):
            xc = F.pad(xc, (*pw, *ph))
            padding = 0
        out = F.conv2d(xc, self.weight.to(x.dtype), self.bias.to(x.dtype),
                       stride=self.stride, padding=padding)
        return out.permute(0, 2, 3, 1)


class FusedConvPool(Conv):
    """Stride-1 SAME conv + 3x3/s2 max-pool through :func:`conv_pool`
    (K3 on CUDA): the pre-pool activation never reaches memory.  The
    parameters are :class:`Conv`'s; the bias is added *after* the pool,
    which is exact: a per-channel constant commutes with the max."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.weight.to(x.dtype).permute(2, 3, 1, 0)  # HWIO
        return conv_pool(x, kernel) + self.bias.to(x.dtype)


class Dense(nn.Module):
    """``nn.Dense``: f32 ``weight [out, in]`` and ``bias [out]``, cast to
    the input's dtype at use.  Left uninitialised: load it, or fill it."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.empty(d_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _pooled(size: int) -> int:
    return _out_dim(size, POOL_WINDOW, POOL_STRIDE)


class AlexNet(nn.Module):
    """Canonical 5-conv / 3-dense AlexNet (single tower) over NHWC.

    With ``s2d=True`` the input is expected space-to-depth transformed
    and the first conv is 3x3/stride 1 over 48 channels; otherwise it is
    the raw 11x11/stride-4 conv with TF-style SAME padding.  ``image_size``
    fixes ``Dense_0``'s input width.  Runs on CUDA unless *device* is
    given."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 dtype: torch.dtype = COMPUTE_DTYPE, s2d: bool = False,
                 pool: str = "xla", image_size: int = IMAGE_SIZE,
                 device=None):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"unknown pool {pool!r}: expected 'xla', "
                             "'pallas', or 'fused'")
        if pool == "fused" and not s2d:
            raise ValueError("pool='fused' requires s2d=True (the raw "
                             "11x11/s4 first conv is not stride-1)")
        device = resolve_device(device)
        self.num_classes, self.dtype = num_classes, dtype
        self.s2d, self.pool, self.image_size = s2d, pool, image_size
        stage = FusedConvPool if pool == "fused" else Conv
        if s2d:
            self.Conv_0 = stage(S2D_BLOCK * S2D_BLOCK * 3, 64, 3,
                                device=device)
        else:
            self.Conv_0 = Conv(3, 64, 11, stride=4, device=device)
        self.Conv_1 = stage(64, 192, 5, device=device)
        self.Conv_2 = Conv(192, 384, 3, device=device)
        self.Conv_3 = Conv(384, 256, 3, device=device)
        self.Conv_4 = stage(256, 256, 3, device=device)
        side = self.feature_side()
        self.Dense_0 = Dense(side * side * 256, 4096, device=device)
        self.Dense_1 = Dense(4096, 4096, device=device)
        self.Dense_2 = Dense(4096, num_classes, device=device)

    def feature_side(self) -> int:
        """Spatial side of the last pooled map (6 at 224 px, 1 at 64)."""
        side = -(-self.image_size // S2D_BLOCK)
        for _ in range(3):
            side = _pooled(side)
        return side

    def _max_pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool == "pallas":
            return max_pool(x, POOL_WINDOW, POOL_STRIDE)
        out = F.max_pool2d(x.permute(0, 3, 1, 2), POOL_WINDOW, POOL_STRIDE)
        return out.permute(0, 2, 3, 1).contiguous()

    def _conv_pool(self, conv: Conv, x: torch.Tensor) -> torch.Tensor:
        """One conv->pool stage, fused or as separate ops."""
        if self.pool == "fused":
            return conv(x)
        return self._max_pool(conv(x).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self._conv_pool(self.Conv_0, x.to(self.dtype)))
        x = F.relu(self._conv_pool(self.Conv_1, x))
        x = F.relu(self.Conv_2(x))
        x = F.relu(self.Conv_3(x))
        x = F.relu(self._conv_pool(self.Conv_4, x))
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x).float()

    def layer_macs(self) -> List[Tuple[str, int]]:
        """Multiply-adds per image of each conv and dense layer, from the
        layer shapes (the work, whatever ``pool`` implements it)."""
        side = -(-self.image_size // S2D_BLOCK)  # every conv_0 output
        sides = [side, _pooled(side)] + [_pooled(_pooled(side))] * 3
        out = []
        for i, s in enumerate(sides):
            w = getattr(self, f"Conv_{i}").weight
            out.append((f"Conv_{i}", s * s * w[0].numel() * w.shape[0]))
        for i in range(3):
            w = getattr(self, f"Dense_{i}").weight
            out.append((f"Dense_{i}", w.numel()))
        return out

    def train_flops_per_image(self) -> int:
        """FLOPs of one training step per image: 2 per multiply-add, the
        forward and both gradients of every layer, less the first conv's
        input gradient, which is never computed."""
        macs = self.layer_macs()
        return 2 * (3 * sum(m for _, m in macs) - macs[0][1])


@torch.no_grad()
def init_params_(model: AlexNet, seed: int = 0) -> None:
    """Random weights at flax's initializer scales, made on the model's
    device from *seed*: conv and dense weights lecun-normal (truncated
    normal, sd 1/sqrt(fan_in)), biases 0."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(".bias"):
            p.zero_()
        else:  # fan_in = everything but the output dim
            _fill_(p, gen, p[0].numel() ** -0.5, truncated=True)


def create_train_state(seed: int = 0, image_size: int = IMAGE_SIZE,
                       num_classes: int = NUM_CLASSES,
                       learning_rate: float = 0.01, s2d: bool = False,
                       pool: str = "xla", dtype: torch.dtype = COMPUTE_DTYPE,
                       device=None) -> Tuple[AlexNet, torch.optim.SGD]:
    """Model with random f32 parameters from *seed*, and its optimizer:
    SGD with momentum 0.9, no dampening, no Nesterov, which is optax
    ``sgd(learning_rate, momentum=0.9)`` (the trace starts at g, then
    becomes g + 0.9 trace; the update is -lr trace)."""
    model = AlexNet(num_classes=num_classes, dtype=dtype, s2d=s2d, pool=pool,
                    image_size=image_size, device=device)
    init_params_(model, seed)
    opt = torch.optim.SGD(model.parameters(), lr=learning_rate,
                          momentum=0.9, dampening=0, nesterov=False)
    return model, opt


def loss_fn(model: AlexNet, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of the f32 logits."""
    return F.cross_entropy(model(images), labels)


def train_step(model: AlexNet, opt: torch.optim.Optimizer,
               images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One SGD step in place; returns the loss (not synchronised)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, images, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def synthetic_batch(gen: torch.Generator, batch_size: int,
                    image_size: int = IMAGE_SIZE,
                    num_classes: int = NUM_CLASSES, s2d: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthetic data on *gen*'s device: bf16 normal images (NHWC,
    space-to-depth applied when *s2d*, as the input pipeline would) and
    int64 labels."""
    images = torch.randn((batch_size, image_size, image_size, 3),
                         generator=gen, device=gen.device).to(COMPUTE_DTYPE)
    if s2d:
        images = space_to_depth(images)
    labels = torch.randint(0, num_classes, (batch_size,), generator=gen,
                           device=gen.device)
    return images, labels
