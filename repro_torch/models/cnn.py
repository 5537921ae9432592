"""The paper's CNNs -- AlexNet, VGG16, VGG19 -- in PyTorch.

The port of ``repro.models.cnn``: the same configs and layer walkers, params
as a list of per-layer dicts ({"w": HWIO or (k, n) weight, "b": bias}, {}
for pools) in NHWC / HWIO layout, so params made by the JAX package convert
one to one (:mod:`repro_torch.convert`).  Every conv goes through
:func:`~repro_torch.core.substrate.conv2d` on the engine the
:class:`~repro_torch.core.planner.ExecutionPlan` names; every FC through
:func:`~repro_torch.core.precision.policy_linear` with the bias in the
kernel epilogue.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core.precision import MatmulPolicy, policy_linear
from repro_torch.core.substrate import (QActivation, QWeight, conv2d,
                                        policy_int_spec, quantize_weight)
from repro_torch.core.systolic import pool2d
from repro_torch.device import resolve_device

#: Thin-stem floor for the pool_quant handoff: a producer with fewer output
#: channels hands no QActivation on (the topology walker and cnn_forward).
HANDOFF_MIN_CIN = 16


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    # layer spec: ("conv", k, cout, stride) | ("pool",) | ("fc", n)
    layers: Tuple[tuple, ...]
    img_size: int
    in_channels: int = 3
    n_classes: int = 1000
    policy: MatmulPolicy = MatmulPolicy.NATIVE_BF16
    conv_path: str = "auto"   # auto | im2col | systolic | implicit | winograd
    family: str = "cnn"

    def replace(self, **kw) -> "CNNConfig":
        return dataclasses.replace(self, **kw)


def _vgg_layers(block_sizes: List[int]) -> Tuple[tuple, ...]:
    chans = [64, 128, 256, 512, 512]
    layers: List[tuple] = []
    for c, n in zip(chans, block_sizes):
        layers += [("conv", 3, c, 1)] * n + [("pool",)]
    layers += [("fc", 4096), ("fc", 4096), ("fc", 1000)]
    return tuple(layers)


ALEXNET = CNNConfig(
    "alexnet",
    (
        ("conv", 11, 96, 4), ("pool",),
        ("conv", 5, 256, 1), ("pool",),
        ("conv", 3, 384, 1), ("conv", 3, 384, 1), ("conv", 3, 256, 1),
        ("pool",),
        ("fc", 4096), ("fc", 4096), ("fc", 1000),
    ),
    img_size=227,
)
VGG16 = CNNConfig("vgg16", _vgg_layers([2, 2, 3, 3, 3]), img_size=224)
VGG19 = CNNConfig("vgg19", _vgg_layers([2, 2, 4, 4, 4]), img_size=224)


def cnn_reduced(cfg: CNNConfig, *, img_size: int | None = None,
                max_channels: int = 16, max_fc: int = 32,
                n_classes: int = 16) -> CNNConfig:
    """CPU-test twin of a CNN config: same topology, tiny widths."""
    if img_size is None:
        img_size = 67 if cfg.name == "alexnet" else 32
    layers = []
    for spec in cfg.layers:
        if spec[0] == "conv":
            _, k, cout, stride = spec
            layers.append(("conv", k, min(cout, max_channels), stride))
        elif spec[0] == "fc":
            layers.append(("fc", min(spec[1], max_fc)))
        else:
            layers.append(spec)
    layers[-1] = ("fc", n_classes)
    return cfg.replace(layers=tuple(layers), img_size=img_size,
                       n_classes=n_classes)


def _first_padding(cfg: CNNConfig, first: bool) -> str:
    return "VALID" if (cfg.name == "alexnet" and first) else "SAME"


def cnn_conv_geometries(cfg: CNNConfig) -> List[dict]:
    """Every conv layer's geometry {kh, kw, stride, h, cin, cout, padding}."""
    out: List[dict] = []
    h, cin = cfg.img_size, cfg.in_channels
    first = True
    for spec in cfg.layers:
        if spec[0] == "conv":
            _, k, cout, stride = spec
            padding = _first_padding(cfg, first)
            oh = ((h - k) // stride + 1) if padding == "VALID" \
                else -(-h // stride)
            first = False
            out.append(dict(kh=k, kw=k, stride=stride, h=h, cin=cin,
                            cout=cout, padding=padding))
            h, cin = oh, cout
        elif spec[0] == "pool":
            h = h // 2
        else:
            break
    return out


def cnn_layer_topology(cfg: CNNConfig) -> List[dict]:
    """:func:`cnn_conv_geometries` plus ``pool_after`` / ``handoff_next``."""
    geoms = cnn_conv_geometries(cfg)
    out: List[dict] = []
    gi = 0
    for i, spec in enumerate(cfg.layers):
        if spec[0] != "conv":
            continue
        g = geoms[gi]
        gi += 1
        pool_after = i + 1 < len(cfg.layers) and cfg.layers[i + 1] == ("pool",)
        nxt = cfg.layers[i + 2] if pool_after and i + 2 < len(cfg.layers) \
            else None
        handoff_next = bool(
            pool_after and nxt is not None and nxt[0] == "conv"
            and nxt[1] == 3 and nxt[3] == 1 and g["cout"] >= HANDOFF_MIN_CIN)
        out.append({**g, "pool_after": pool_after,
                    "handoff_next": handoff_next})
    return out


def cnn_init(cfg: CNNConfig, generator: torch.Generator, *, device=None,
             dtype=torch.float32) -> list:
    """Random params from ``generator`` (a CPU ``torch.Generator``), made on
    the CPU and moved to ``device`` (default: the GPU, see resolve_device).
    Biases are zero, as in the reference."""
    dev = resolve_device(device)
    params = []
    cin, feat, h, first = cfg.in_channels, None, cfg.img_size, True
    for spec in cfg.layers:
        if spec[0] == "conv":
            _, k, cout, stride = spec
            w = torch.randn((k, k, cin, cout), generator=generator,
                            dtype=dtype) / (k * k * cin) ** 0.5
            params.append({"w": w.to(dev),
                           "b": torch.zeros((cout,), dtype=dtype,
                                            device=dev)})
            cin = cout
            h = ((h - k) // stride + 1) if _first_padding(cfg, first) \
                == "VALID" else -(-h // stride)
            first = False
        elif spec[0] == "pool":
            params.append({})
            h = h // 2
        else:
            _, n = spec
            if feat is None:
                feat = h * h * cin
            w = torch.randn((feat, n), generator=generator,
                            dtype=dtype) / feat ** 0.5
            params.append({"w": w.to(dev),
                           "b": torch.zeros((n,), dtype=dtype, device=dev)})
            feat = n
    return params


def cnn_quantize_params(params, cfg: CNNConfig) -> list:
    """Quantize every conv/FC weight ONCE, per output channel (int policies).
    Float policies return ``params`` unchanged."""
    spec = policy_int_spec(cfg.policy)
    if spec is None:
        return params
    out = []
    for p in params:
        if "w" in p and not isinstance(p["w"], QWeight):
            out.append({**p, "w": quantize_weight(p["w"], base_bits=spec[1])})
        else:
            out.append(p)
    return out


def _handoff_consumer_ok(cfg: CNNConfig, params, i: int) -> bool:
    """True iff conv position ``i``'s pool_quant handoff has a taker.

    The layer after position ``i``'s pool must be a 3x3/s1 conv on the
    cached-QWeight serving path, fed by at least HANDOFF_MIN_CIN channels
    -- the conditions under which :func:`conv2d` accepts a QActivation.
    """
    j = i + 2
    if j >= len(cfg.layers) or cfg.layers[j][0] != "conv":
        return False
    _, k2, _, stride2 = cfg.layers[j]
    _, _, cout_i, _ = cfg.layers[i]
    return (k2 == 3 and stride2 == 1 and cout_i >= HANDOFF_MIN_CIN
            and isinstance(params[j]["w"], QWeight))


def cnn_forward(params, cfg: CNNConfig, x: torch.Tensor, plan=None, *,
                fuse: bool = True) -> torch.Tensor:
    """x: (n, H, W, C) image batch -> (n, n_classes) logits.

    ``plan``: an ExecutionPlan fixing each conv layer's engine; ``None`` with
    ``cfg.conv_path == "auto"`` resolves the heuristic plan for the device
    ``x`` lives on.  Plan entries apply to layers on the cached-weight path
    and layers a plan does not cover fall back to auto dispatch, as in the
    reference.  A pinned ``cfg.conv_path`` (e.g. ``"systolic"``, or
    ``"implicit"`` under ``bf16x3``) sends EVERY conv, the stem included,
    to that engine and ignores any plan.

    Entries with ``fusion`` "pool"/"pool_quant" fold the FOLLOWING maxpool
    (and the next layer's activation quantization) into the implicit conv's
    epilogue where the topology allows it (a pool next; for pool_quant an
    eligible 3x3/s1 consumer, which then reads the QActivation).
    ``fuse=False`` runs the unfused pipeline for the same plan (conv, then
    ``pool2d``, then ``handoff_quantize``); the two are bitwise equal.
    """
    use_plan = cfg.conv_path == "auto"
    if use_plan and plan is None:
        from repro_torch.core.planner import resolve_plan
        plan = resolve_plan(cfg, backend=x.device.type)
    spec_int = policy_int_spec(cfg.policy)
    int_policy = spec_int is not None
    first_conv = True
    skip_pool = False        # the previous conv already pooled in-epilogue
    quant_after_pool = None  # unfused pipeline: quantize after pool2d
    for i, spec in enumerate(cfg.layers):
        p = params[i]
        if spec[0] == "conv":
            _, k, cout, stride = spec
            padding = _first_padding(cfg, first_conv)
            first_conv = False
            path, block, fusion = cfg.conv_path, None, "bias_relu"
            if use_plan and plan is not None \
                    and (not int_policy or isinstance(p["w"], QWeight)):
                ent = plan.lookup(kh=k, kw=k, stride=stride, h=x.shape[1],
                                  cin=x.shape[3], cout=cout, padding=padding)
                if ent is not None:
                    path, block, fusion = ent.path, ent.block, ent.fusion
            if isinstance(x, QActivation) and path != "implicit":
                # A handoff input is an implicit-engine contract.
                path, block = "implicit", None
            do_pool = (fusion in ("pool", "pool_quant") and path == "implicit"
                       and i + 1 < len(cfg.layers)
                       and cfg.layers[i + 1] == ("pool",))
            do_quant = (do_pool and fusion == "pool_quant" and int_policy
                        and _handoff_consumer_ok(cfg, params, i))
            if fuse and do_pool:
                x = conv2d(x, p["w"], stride=stride, padding=padding,
                           policy=cfg.policy, path=path, block=block,
                           bias=p["b"], activation="relu",
                           pool=(2, 2, "VALID"),
                           quantize_next=spec_int[1] if do_quant else None)
                skip_pool = True
            else:
                x = conv2d(x, p["w"], stride=stride, padding=padding,
                           policy=cfg.policy, path=path, block=block,
                           bias=p["b"], activation="relu")
                if do_quant:
                    quant_after_pool = spec_int[1]
        elif spec[0] == "pool":
            if skip_pool:
                skip_pool = False
            else:
                x = pool2d(x, window=2, stride=2, kind="max")
                if quant_after_pool is not None:
                    from repro_torch.kernels.conv2d import handoff_quantize
                    x = handoff_quantize(x, base_bits=quant_after_pool)
                    quant_after_pool = None
        else:
            if x.ndim == 4:
                x = x.reshape(x.shape[0], -1)
            x = policy_linear(x, p["w"], policy=cfg.policy, bias=p["b"])
            if i != len(cfg.layers) - 1:
                x = torch.relu(x)
    return x
