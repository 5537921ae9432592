"""The conv tile tuner and the traffic model, on the port's kernels.

The port of ``repro.core.tuning``.  The port's kernels fix their tiles in
CUDA (``csrc/implicit_conv.cu``: 64 x 128 with a ring of ``STAGES``;
``csrc/systolic_conv.cu`` with ``conv2d.systolic_plan``;
``csrc/winograd.cu`` with ``winograd.winograd_plan``), so of a block only
the implicit engine's Cin chunk ``bk`` is a knob
(``kernels/conv2d/ops.py``): it sets the recombine groups of layers too
deep for one int32 accumulation and the handoff consumer's f32 order.

* **Feasibility** (:func:`feasible`): the wrap-free cap on ``bk``
  (``implicit_gemm.max_cin_block``), pool fusions on the implicit engine
  only, Winograd's eligibility and growth bound, and the systolic tile
  the kernel runs.  Each kernel asserts at compile time that its dynamic
  shared memory fits a Hopper block's 227 KB.  Pure arithmetic:
  ``python -m repro_torch.core.tuning --check``.
* **Measured sweep** (:func:`tune_layer`, :func:`tune_model`,
  :func:`tune_config`): time the public conv wrapper over the candidate
  ``bk`` (:func:`candidate_blocks`) on a device, synchronized
  (:func:`_time_call`), and persist the argmin.  The systolic and
  Winograd engines have nothing to sweep: their entry is the tile the
  kernel runs.
* **Cache** (:class:`TuneCache`): JSON under ``repro_torch/tuned/`` (or
  ``$REPRO_TORCH_TUNED_DIR``): ``default.json`` committed, ``*.local.json``
  machine-local and git-ignored, local entries win.  Keys are
  backend-scoped (:func:`layer_key`), so a ``cuda`` entry never changes a
  CPU run.  The same cache holds the thin-stem threshold
  (:func:`stem_cin`, key ``dispatch|stem_cin|<backend>``).
* **Resolution** (:func:`resolve_block`): what the conv wrappers call
  when no block is given -- a cache hit that is still feasible, else
  :func:`default_block`.

Device-memory traffic model (:func:`conv_hbm_bytes`), the port of
``repro.core.tuning.conv_hbm_bytes`` with its ``fusion`` and
``handoff_in`` axes, re-derived for the port's own dataflow (the TPU's
VMEM model and tile defaults do not apply).  Each engine is a tiled GEMM
that re-reads its A source once per Cout tile and its weights once per M
tile, with no credit for the 50 MB L2 -- a model for ranking engines, not
a measurement.  Its tiles (:data:`IMPLICIT_TILE`, :data:`WINOGRAD_TILE`,
...) are the ones the kernels ran when the model was written, and the
model-only explorer ranks by them:

* ``implicit`` (``csrc/implicit_conv.cu``): 64 output pixels x 64 output
  channels per block, one image per block; with a pooled epilogue a block
  covers 16 pooled pixels (64 conv pixels).  A source: the compact NHWC
  input (f32, or the handoff's padded int16 plus its cell-scale grid) and
  the per-patch scales.
* ``systolic`` (``csrc/systolic_conv.cu``): the implicit kernel's tiles.
  Under the integer variants the input is quantized per sample first (an
  abs-max read and a quantize read of the f32 input, an int16 write), and
  the kernel re-reads the int16 map per Cout tile; ``native`` re-reads the
  f32 input.  The (n, cout) scale product rides along.
* ``winograd`` (``csrc/winograd.cu``): 32 tiles (flattened over the batch)
  x 64 output channels per block; the A source is the NHWC input plus the
  tile scales, the weights are the two int16 transformed planes (16
  points).
* ``im2col``: ``F.unfold`` writes the f32 patch matrix, the quantizer reads
  it and writes int16, and the limb GEMM (64 x 64 tiles) re-reads that per
  Cout tile.

The float variants (``native``, ``bf16x3``, ``bf16x6``) read f32 inputs and
f32 weights and have no activation scales.

Outputs and the PyTorch passes after the kernel: the kernel writes its f32
output (the pooled map under ``pool``/``pool_quant``); ReLU is one
in-place pass over it (read + write); ``"none"`` adds a separate bias pass;
``pool_quant`` adds ``handoff_quantize`` (read the pooled f32, write the
padded int16 values and the cell grid).  ``handoff_in`` prices the
consumer's A side as int16 + grid and drops its per-patch scales.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import tempfile
import time
from typing import Iterable, Optional

#: The traffic model's tiles.
IMPLICIT_TILE = (64, 64)          # output pixels, output channels
SYSTOLIC_TILE = (64, 64)          # output pixels, output channels
IMPLICIT_POOLED_PIXELS = 16       # pooled pixels per implicit block
WINOGRAD_TILE = (32, 64)          # Winograd tiles, output channels
GEMM_TILE = (64, 64)              # limb GEMM rows, columns

_INT_VARIANTS = ("karatsuba", "schoolbook")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_hbm_bytes(path: str, *, kh, kw, stride, h, cin, cout, variant,
                   n: int = 1, fusion: str = "bias_relu",
                   handoff_in: bool = False) -> int:
    """Modeled device-memory bytes of one conv call (batch ``n``, SAME)."""
    integer = variant in _INT_VARIANTS
    ho = wo = _cdiv(h, stride)
    m = n * ho * wo
    kdim = kh * kw * cin
    if handoff_in:
        x_bytes = n * (h + 2) * (h + 2) * cin * 2 + n * _cdiv(h, 2) ** 2 * 4
    else:
        x_bytes = n * h * h * cin * 4
    hp, wp = max(ho // 2, 1), max(wo // 2, 1)     # 2x2/s2 VALID pool
    if fusion in ("pool", "pool_quant"):
        out_bytes = n * hp * wp * cout * 4
    elif fusion in ("bias_relu", "none"):
        out_bytes = m * cout * 4
    else:
        raise ValueError(f"unknown fusion {fusion!r}")
    passes = 2 * out_bytes                        # in-place ReLU
    if fusion == "none":
        passes += 2 * out_bytes                   # separate bias add
    if fusion == "pool_quant":
        passes += (out_bytes + n * (hp + 2) * (wp + 2) * cout * 2
                   + n * _cdiv(hp, 2) * _cdiv(wp, 2) * 4)
    w_elt = 2 if integer else 4
    w_bytes = kdim * cout * w_elt
    tail = out_bytes + passes
    if path == "im2col":
        patches = m * kdim
        cout_tiles = _cdiv(cout, GEMM_TILE[1])
        m_tiles = _cdiv(m, GEMM_TILE[0])
        return (x_bytes + 2 * 4 * patches            # unfold write, read
                + 2 * patches * (1 + cout_tiles)     # int16 write, re-reads
                + w_bytes * m_tiles + tail)
    if path == "implicit":
        cout_tiles = _cdiv(cout, IMPLICIT_TILE[1])
        if fusion in ("pool", "pool_quant"):
            m_tiles = n * _cdiv(hp * wp, IMPLICIT_POOLED_PIXELS)
        else:
            m_tiles = n * _cdiv(ho * wo, IMPLICIT_TILE[0])
        scales = m * 4 if integer and not handoff_in else 0
        return ((x_bytes + scales) * cout_tiles + w_bytes * m_tiles + tail)
    if path == "systolic":
        if fusion not in ("none", "bias_relu") or handoff_in:
            raise ValueError("the systolic engine fuses bias and ReLU only")
        cout_tiles = _cdiv(cout, SYSTOLIC_TILE[1])
        m_tiles = n * _cdiv(ho * wo, SYSTOLIC_TILE[0])
        if not integer:
            return x_bytes * cout_tiles + w_bytes * m_tiles + tail
        x16 = n * h * h * cin * 2
        return (2 * x_bytes + x16 + x16 * cout_tiles + w_bytes * m_tiles
                + n * cout * 4 + tail)
    if path == "winograd":
        th, tw = _cdiv(ho, 2), _cdiv(wo, 2)
        cout_tiles = _cdiv(cout, WINOGRAD_TILE[1])
        m_tiles = _cdiv(n * th * tw, WINOGRAD_TILE[0])
        planes = 2 * 16 * cin * cout * 2
        scales = n * th * tw * 4
        return ((x_bytes + scales) * cout_tiles + planes * m_tiles
                + cout * 4 + tail)
    raise ValueError(f"unknown path {path!r}")


# ---------------------------------------------------------------------------
# Feasibility: the wrap-free chunk, eligibility, the kernels' own tiles.
# ---------------------------------------------------------------------------

def _int_variant(variant: str) -> bool:
    return variant in _INT_VARIANTS


def _max_cin_block(kh, kw, variant, base_bits) -> int:
    from repro_torch.kernels.conv2d.implicit_gemm import max_cin_block
    return max_cin_block(kh, kw, variant=variant, base_bits=base_bits)


def systolic_tile(cout: int) -> tuple:
    """The systolic kernel's block tile (``conv2d.systolic_plan``)."""
    return (128, 64) if cout <= 64 else (64, 128)


def default_block(kind: str, *, kh, kw, stride, h, cin, cout, variant,
                  base_bits) -> tuple:
    """The block a layer runs with when the cache has no entry.

    ``implicit``: the traffic model's tile and the widest wrap-free Cin
    chunk (the whole Cin when one int32 accumulation holds it; float
    variants read no chunk).  ``systolic``/``winograd``: the tile the
    kernel runs.
    """
    del stride, h
    if kind == "implicit":
        bk = cin
        if _int_variant(variant):
            bk = min(cin, _max_cin_block(kh, kw, variant, base_bits))
        return (*IMPLICIT_TILE, bk)
    if kind == "systolic":
        return systolic_tile(cout)
    if kind == "winograd":
        from repro_torch.kernels.conv2d.winograd import WINOGRAD_BLOCK
        return tuple(WINOGRAD_BLOCK)
    raise ValueError(f"unknown kind {kind!r}")


def feasible(kind: str, *, kh, kw, stride, h, cin, cout, variant,
             base_bits, block, fusion: str = "bias_relu") -> tuple[bool, str]:
    """(ok, reason) for running ``kind`` with ``block`` on this layer.

    Pool fusions run on the implicit engine only.  ``implicit``: the Cin
    chunk within [1, cin] and, under an integer variant, at most the
    wrap-free cap; ``systolic``: the kernel's own tile; ``winograd``:
    3x3/s1, an integer variant and the growth bound.  Every tile is fixed
    in CUDA, where each kernel asserts at compile time that its dynamic
    shared memory fits a Hopper block's 227 KB, so no block can fail on
    shared memory here.
    """
    del h
    integer = _int_variant(variant)
    if fusion in ("pool", "pool_quant") and kind != "implicit":
        return False, (f"fusion {fusion!r} needs the implicit engine's "
                       f"pooled epilogue, not {kind!r}")
    block = tuple(int(b) for b in block)
    if kind == "implicit":
        if len(block) != 3:
            return False, f"implicit block must be (bm, bc, bk), got {block}"
        bk = block[2]
        if bk < 1:
            return False, f"bk={bk} < 1"
        if integer:
            cap = _max_cin_block(kh, kw, variant, base_bits)
            if min(bk, cin) > cap:
                return False, (f"bk={bk}: one K step would wrap int32 "
                               f"(cap {cap})")
    elif kind == "systolic":
        want = systolic_tile(cout)
        if block != want:
            return False, (f"the systolic kernel runs tile {want} here, "
                           f"not {block}")
    elif kind == "winograd":
        if (kh, kw, stride) != (3, 3, 1):
            return False, f"winograd needs 3x3/s1, got k{kh}x{kw} s{stride}"
        if not integer:
            return False, f"winograd needs an int variant, got {variant!r}"
        from repro_torch.kernels.conv2d.winograd import (WINOGRAD_BLOCK,
                                                         winograd_accum_bound)
        if winograd_accum_bound(cin, variant=variant,
                                base_bits=base_bits) >= 2**31:
            return False, f"cin={cin}: tile contraction would wrap int32"
        if block != tuple(WINOGRAD_BLOCK):
            return False, (f"the winograd kernel runs tile "
                           f"{tuple(WINOGRAD_BLOCK)}, not {block}")
    else:
        return False, f"unknown kind {kind!r}"
    return True, ""


def candidate_blocks(kind: str, *, kh, kw, stride, h, cin, cout, variant,
                     base_bits) -> list[tuple]:
    """The feasible blocks of the measured sweep.

    ``implicit``: ``bk`` over {128, 256, 512, 1024, 2048} within [1, cin],
    the wrap-free cap and cin itself.  ``systolic``/``winograd``: the
    kernel's one tile.
    """
    geo = dict(kh=kh, kw=kw, stride=stride, h=h, cin=cin, cout=cout,
               variant=variant, base_bits=base_bits)
    base = default_block(kind, **geo)
    if kind != "implicit":
        return [base] if feasible(kind, block=base, **geo)[0] else []
    bks = {b for b in (128, 256, 512, 1024, 2048) if b <= cin} | {cin}
    if _int_variant(variant):
        bks.add(min(cin, _max_cin_block(kh, kw, variant, base_bits)))
    out = []
    for bk in sorted(bks):
        block = (*IMPLICIT_TILE, bk)
        if feasible(kind, block=block, **geo)[0]:
            out.append(block)
    return out


# ---------------------------------------------------------------------------
# The persistent cache.
# ---------------------------------------------------------------------------

CACHE_ENV = "REPRO_TORCH_TUNED_DIR"
DEFAULT_CACHE_NAME = "default.json"
LOCAL_CACHE_NAME = "measured.local.json"
SCHEMA = "conv-tile-cache/v1"


_PKG_TUNED = str(pathlib.Path(__file__).resolve().parent.parent / "tuned")


def _where() -> str:
    return os.environ.get(CACHE_ENV) or _PKG_TUNED


def tuned_dir() -> pathlib.Path:
    """``repro_torch/tuned/`` (or ``$REPRO_TORCH_TUNED_DIR``): the tile
    cache and, under ``plans/``, the plan artifacts."""
    return pathlib.Path(_where())


def layer_key(kind: str, *, kh, kw, stride, h, cin, cout, variant, base_bits,
              backend: str) -> str:
    """Cache key: engine, multiplier, layer geometry, backend."""
    return (f"{kind}|{variant}|b{base_bits}|k{kh}x{kw}|s{stride}|h{h}"
            f"|cin{cin}|cout{cout}|{backend}")


class TuneCache:
    """The persistent JSON cache: {key: {block, us, measured}}."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.entries: dict = {}

    @classmethod
    def load(cls, path) -> "TuneCache":
        cache = cls(path)
        p = pathlib.Path(path)
        if p.exists():
            data = json.loads(p.read_text())
            if data.get("schema") == SCHEMA:
                cache.entries = data.get("entries", {})
        return cache

    def save(self) -> None:
        """Atomic write (temporary file, then rename)."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"schema": SCHEMA, "entries": self.entries}
        fd, tmp = tempfile.mkstemp(dir=self.path.parent, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        clear_caches()

    def get(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def put(self, key: str, block, *, us: Optional[float] = None,
            measured: bool = True) -> None:
        self.entries[key] = {"block": list(block), "us": us,
                             "measured": measured}

    def put_stem(self, cin: int, *, backend: str) -> None:
        """Persist the thin-stem threshold for ``backend``."""
        self.entries[stem_key(backend)] = {"cin": int(cin)}


#: Thin-stem threshold when the cache has none: below this Cin a conv keeps
#: the materialized patch GEMM (its per-tap contraction starves the
#: streaming engines).
DEFAULT_STEM_CIN = 16


def stem_key(backend: str) -> str:
    return f"dispatch|stem_cin|{backend}"


def stem_cin(backend: str) -> int:
    """The thin-stem Cin threshold for ``backend``: the cache's
    ``{"cin": N}`` (an int >= 1) under :func:`stem_key`, else
    :data:`DEFAULT_STEM_CIN`; a malformed entry is ignored."""
    return _stem_cin(backend, _where())


@functools.lru_cache(maxsize=None)
def _stem_cin(backend: str, where: str) -> int:
    ent = _cache().get(stem_key(backend))
    if isinstance(ent, dict):
        cin = ent.get("cin")
        if isinstance(cin, int) and not isinstance(cin, bool) and cin >= 1:
            return cin
    return DEFAULT_STEM_CIN


@functools.lru_cache(maxsize=None)
def _load_cache(stamp: tuple) -> TuneCache:
    merged = TuneCache(stamp[0][0] if stamp else DEFAULT_CACHE_NAME)
    for path_str, _mtime in stamp:
        merged.entries.update(TuneCache.load(path_str).entries)
    return merged


def clear_caches() -> None:
    """Forget what this process has read of the tuner's files (called by
    :meth:`TuneCache.save`; call it after editing them by hand)."""
    _load_cache.cache_clear()
    _stem_cin.cache_clear()
    _resolve_block.cache_clear()


def _cache() -> TuneCache:
    """The committed ``default.json`` overlaid by every ``*.local.json``
    (machine-local measurements): local entries win."""
    d = tuned_dir()
    paths = [d / DEFAULT_CACHE_NAME]
    if d.exists():
        paths += sorted(d.glob("*.local.json"))
    stamp = tuple((str(p), p.stat().st_mtime_ns) for p in paths
                  if p.exists())
    return _load_cache(stamp)


def resolve_block(kind: str, *, kh, kw, stride, h, cin, cout, variant,
                  base_bits, backend: str) -> tuple:
    """A layer's block on ``backend``: a cache hit that is still feasible,
    else :func:`default_block`.  Resolved once per layer and cache
    directory in a process (every conv call without a block asks), until
    :func:`clear_caches`."""
    return _resolve_block(kind, kh, kw, stride, h, cin, cout, variant,
                          base_bits, backend, _where())


@functools.lru_cache(maxsize=None)
def _resolve_block(kind, kh, kw, stride, h, cin, cout, variant, base_bits,
                   backend, where) -> tuple:
    geo = dict(kh=kh, kw=kw, stride=stride, h=h, cin=cin, cout=cout,
               variant=variant, base_bits=base_bits)
    ent = _cache().get(layer_key(kind, backend=backend, **geo))
    if isinstance(ent, dict) and isinstance(ent.get("block"), list):
        block = tuple(ent["block"])
        if feasible(kind, block=block, **geo)[0]:
            return block
    return default_block(kind, **geo)


# ---------------------------------------------------------------------------
# The measured sweep.
# ---------------------------------------------------------------------------

def _sync(args) -> None:
    import torch
    for a in args:
        dev = getattr(a, "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda":
            torch.cuda.synchronize(dev)
            return


def _time_call(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median wall microseconds of ``fn(*args)``, the device synchronized
    before and after each call (without it a CUDA call would time its
    launch alone), after ``warmup`` calls (builds, allocator)."""
    import statistics
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        _sync(args)
        t0 = time.perf_counter()
        fn(*args)
        _sync(args)
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(ts))


def _layer_operands(*, kh, kw, h, cin, cout, variant, base_bits, device):
    """Seed-0 batch-1 input and HWIO weight (a QWeight under an integer
    variant), as the reference's sweep makes them."""
    import numpy as np
    import torch

    from .substrate import quantize_weight

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, h, h, cin)).astype(
        np.float32)).to(device)
    w = torch.from_numpy((rng.standard_normal((kh, kw, cin, cout)) * 0.1
                          ).astype(np.float32)).to(device)
    if _int_variant(variant):
        w = quantize_weight(w, base_bits=base_bits)
    return x, w


def tune_layer(kind: str, *, kh, kw, stride, h, cin, cout, variant,
               base_bits, iters: int = 3, cache: Optional[TuneCache] = None,
               verbose: bool = False, device=None) -> tuple:
    """Time the candidate blocks of ``kind`` on ``device`` (default the
    GPU), persist the fastest into ``cache`` under the device's backend,
    return it.  ``systolic``/``winograd`` return the kernel's tile
    untimed.  A wrapper's refusal (ValueError) prunes a candidate; a CUDA
    error propagates."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels.conv2d import conv2d_implicit

    geo = dict(kh=kh, kw=kw, stride=stride, h=h, cin=cin, cout=cout,
               variant=variant, base_bits=base_bits)
    if kind != "implicit":
        return default_block(kind, **geo)
    dev = resolve_device(device)
    x, w = _layer_operands(kh=kh, kw=kw, h=h, cin=cin, cout=cout,
                           variant=variant, base_bits=base_bits, device=dev)
    best, best_us = None, float("inf")
    with torch.inference_mode():
        for block in candidate_blocks(kind, **geo):
            fn = functools.partial(conv2d_implicit, stride=stride,
                                   variant=variant, base_bits=base_bits,
                                   block=block)
            try:
                us = _time_call(fn, x, w, iters=iters)
            except ValueError as e:
                if verbose:
                    print(f"    {block}: refused ({e})")
                continue
            if verbose:
                print(f"    {block}: {us:.1f} us")
            if us < best_us:
                best, best_us = tuple(block), us
    if best is None:
        return default_block(kind, **geo)
    if cache is not None:
        cache.put(layer_key(kind, backend=dev.type, **geo), best, us=best_us)
    return best


def conv_layer_shapes(cfg) -> list[dict]:
    """Unique conv layer geometries of a CNN config, padding dropped."""
    from repro_torch.models.cnn import cnn_conv_geometries

    shapes, seen = [], set()
    for g in cnn_conv_geometries(cfg):
        key = (g["kh"], g["stride"], g["h"], g["cin"], g["cout"])
        if key not in seen:
            seen.add(key)
            shapes.append({k: v for k, v in g.items() if k != "padding"})
    return shapes


def tune_model(name: str, *, policies=("kom_int14", "schoolbook_int16"),
               kinds=("implicit", "systolic", "winograd"), iters: int = 3,
               cache_path=None, verbose: bool = True,
               device=None) -> TuneCache:
    """The measured sweep over every unique conv layer of a registered CNN,
    into ``cache_path`` (default the committed ``default.json``)."""
    from repro_torch.configs import get_config

    from .planner import _policy_variant

    cache = TuneCache.load(cache_path or tuned_dir() / DEFAULT_CACHE_NAME)
    for layer in conv_layer_shapes(get_config(name)):
        for policy in policies:
            variant, base_bits = _policy_variant(policy)
            for kind in kinds:
                if verbose:
                    print(f"{name} {kind} {policy} k{layer['kh']} "
                          f"s{layer['stride']} h{layer['h']} "
                          f"cin{layer['cin']} cout{layer['cout']}:")
                tune_layer(kind, variant=variant, base_bits=base_bits,
                           iters=iters, cache=cache, verbose=verbose,
                           device=device, **layer)
    cache.save()
    return cache


def tune_config(cfg, *, iters: int = 2, cache_path=None,
                verbose: bool = False, device=None) -> TuneCache:
    """The measured sweep for one config's conv layers under its policy,
    into ``measured.local.json`` (git-ignored): an engine build never
    rewrites the committed ``default.json``."""
    from .planner import _policy_variant

    cache = TuneCache.load(cache_path or tuned_dir() / LOCAL_CACHE_NAME)
    variant, base_bits = _policy_variant(cfg.policy)
    for layer in conv_layer_shapes(cfg):
        for kind in ("implicit", "systolic", "winograd"):
            tune_layer(kind, variant=variant, base_bits=base_bits,
                       iters=iters, cache=cache, verbose=verbose,
                       device=device, **layer)
    cache.save()
    return cache


# ---------------------------------------------------------------------------
# Check mode: feasibility only, no execution.
# ---------------------------------------------------------------------------

def check(models: Iterable[str] = ("alexnet", "vgg16", "vgg19"),
          policies=("kom_int14", "schoolbook_int16", "fp32"),
          backends=("cuda", "cpu")) -> list[str]:
    """Resolve every layer's block on each backend and hold it to
    :func:`feasible` (the implicit engine everywhere, the heuristic's
    engine where it picks another) and the implicit chunk to a wrap-free
    recombine schedule.  Returns the violations."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.conv2d.implicit_gemm import recombine_schedule

    from .planner import _policy_variant, heuristic_path

    errors = []
    for name in models:
        for layer in conv_layer_shapes(get_config(name)):
            for policy in policies:
                variant, base_bits = _policy_variant(policy)
                geo = dict(variant=variant, base_bits=base_bits, **layer)
                for backend in backends:
                    kinds = ["implicit"]
                    sel = heuristic_path(
                        kh=layer["kh"], kw=layer["kw"],
                        stride=layer["stride"], cin=layer["cin"],
                        cout=layer["cout"], policy=policy,
                        cached_weight=True, backend=backend)
                    if sel in ("systolic", "winograd"):
                        kinds.append(sel)
                    for kind in kinds:
                        block = resolve_block(kind, backend=backend, **geo)
                        ok, why = feasible(kind, block=block, **geo)
                        if not ok:
                            errors.append(f"{name}/{policy}/{kind}/{backend}"
                                          f" {layer}: {block} -- {why}")
                    if _int_variant(variant):
                        bk = resolve_block("implicit", backend=backend,
                                           **geo)[2]
                        try:
                            recombine_schedule(
                                layer["kh"], layer["kw"], layer["cin"],
                                min(bk, layer["cin"]), variant=variant,
                                base_bits=base_bits)
                        except ValueError as e:
                            errors.append(f"{name}/{policy}/implicit/"
                                          f"{backend} {layer}: {e}")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Check the conv tile cache (no execution) or run the "
                    "measured bk sweep on a device.")
    ap.add_argument("--check", action="store_true",
                    help="feasibility only, no execution")
    ap.add_argument("--tune", action="store_true",
                    help="measured sweep on --device, persisted to --cache")
    ap.add_argument("--models", nargs="*",
                    default=["alexnet", "vgg16", "vgg19"])
    ap.add_argument("--policies", nargs="*",
                    default=["kom_int14", "schoolbook_int16", "fp32"])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cache", default=None,
                    help="cache path (default repro_torch/tuned/"
                         "default.json)")
    ap.add_argument("--device", default=None,
                    help="device of the sweep (default: the GPU)")
    args = ap.parse_args(argv)
    if args.check:
        errors = check(models=args.models, policies=tuple(args.policies))
        for e in errors:
            print(f"INFEASIBLE: {e}")
        print(f"tile feasibility: {len(errors)} violation(s)")
        return 1 if errors else 0
    if args.tune:
        for name in args.models:
            tune_model(name, policies=tuple(args.policies),
                       iters=args.iters, cache_path=args.cache,
                       device=args.device)
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
