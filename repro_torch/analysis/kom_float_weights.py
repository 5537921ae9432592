"""Why the reduced xLSTM's float-weight ``kom_int14`` forward moves between
devices, and how far an ulp of input moves it.

With float weights (no engine prequantization) every projection goes
through :func:`~repro_torch.core.precision.kom_q_dot`, which quantizes both
operands per TENSOR: one scale for all rows of the activation and one for
the whole weight.  Two measurements, on the reduced xlstm-125m of
``tests/test_torch_cuda.py::test_reduced_xlstm_on_card_matches_cpu``
(params seed 2, tokens (2, 40) seed 3, f32 compute):

* ``ops`` (needs a card): the forward on the CPU and on the card (kernels
  swapped for their plain versions, which the card tests hold equal to the
  kernels bit for bit, so both runs issue the same aten ops in the same
  order) under a dispatch mode that records every aten op.  Each op is
  then replayed on the card from the CPU run's own inputs: an op that
  computes differently on the card from identical inputs shows up by
  itself, apart from the differences it inherits.  The per-tensor
  quantizations (``quantize_values`` inside ``kom_q_dot``) are recorded
  too: the first one whose scale or integers differ between the devices,
  whether its float input already differed, and whether the card's
  quantizer, fed the CPU's input, gives the CPU's integers.
* ``ulp`` (any device): how far the forward's and four decode steps'
  logits move (``max|d| / max|logit|``) when half of the embedding output
  moves by one f32 ulp, over a few seeds, for float weights, for weights
  quantized once as the serving engine does, and, as the control that a
  limit must tell apart, float weights quantized with ``base_bits=6``
  against the same forward at ``base_bits=7``.

    python -m repro_torch.analysis.kom_float_weights [--device cuda]
        [--seeds 4]
"""
from __future__ import annotations

import argparse
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

ARCH = "xlstm-125m"
#: The float-weight path's card-vs-CPU limit, of max |logit|.  Moving half
#: the embedding output by one f32 ulp moves its logits by up to 2.66e-3 on
#: the CPU (``ulp``, 16 seeds; weights quantized once: up to 9.0e-4, under
#: their 2e-3), so a 2e-3 limit is below the path's own ulp noise; the limit
#: is about twice that move, and the ``base_bits=6`` control lands 3.0e-2
#: away.
FLOAT_WEIGHTS_TOL = 5e-3


def reduced_xlstm():
    """(cfg, CPU params, tokens) of the reduced card-vs-CPU check."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.precision import MatmulPolicy
    from repro_torch.models import transformer

    cfg = reduced(get_config(ARCH)).replace(policy=MatmulPolicy.KOM_INT14,
                                           compute_dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(2),
                                     device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(3))
    return cfg, params, tokens


def run_logits(params, cfg, tokens, n_decode: int = 4) -> list:
    """[forward logits, decode-step logits ...] on ``params``' device."""
    from repro_torch.models import transformer

    dev = params["embed"].device
    tokens = tokens.to(dev)
    with torch.inference_mode():
        out = [transformer.forward(params, cfg, {"tokens": tokens})[0]]
        cache = transformer.init_cache(cfg, tokens.shape[0], 8, device=dev)
        for t in range(n_decode):
            g, cache = transformer.serve_step(params, cfg, cache,
                                              tokens[:, t:t + 1], t)
            out.append(g)
    return [o.float().cpu() for o in out]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max|a - b| / max|b|`` in f64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@contextlib.contextmanager
def patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def embed_moved(seed: int):
    """Half of every embedding output (chosen by ``seed``) one f32 ulp up."""
    from repro_torch.models import transformer

    orig = transformer._embed
    gen = torch.Generator().manual_seed(seed)

    def moved(params, cfg, tokens):
        x = orig(params, cfg, tokens)
        pick = (torch.rand(x.shape, generator=gen) < 0.5).to(x.device)
        return torch.where(pick, torch.nextafter(
            x, torch.full_like(x, float("inf"))), x)
    with patched(transformer, "_embed", moved):
        yield


@contextlib.contextmanager
def base_bits(bits: int):
    """Every per-tensor ``kom_q_dot`` quantizes with ``bits``."""
    from repro_torch.core import precision

    orig = precision.kom_q_dot

    def q_dot(a, b, *, variant, base_bits, bias=None):
        del base_bits
        return orig(a, b, variant=variant, base_bits=bits, bias=bias)
    with patched(precision, "kom_q_dot", q_dot):
        yield


def ulp_sensitivity(device: str = "cpu", seeds=range(4)) -> dict:
    """{case: [max over the forward and decode steps of the relative logit
    move, one per seed]}; see the module note."""
    from repro_torch.models import transformer
    from repro_torch.serving.weight_quant import quantize_params_inline

    cfg, params, tokens = reduced_xlstm()
    cases = {"float_weights": transformer.params_to(params, device),
             "prequantized": transformer.params_to(
                 quantize_params_inline(params), device)}
    out = {k: [] for k in cases}
    base = {k: run_logits(p, cfg, tokens) for k, p in cases.items()}
    for seed in seeds:
        for k, p in cases.items():
            with embed_moved(seed):
                got = run_logits(p, cfg, tokens)
            out[k].append(max(rel(g, w) for g, w in zip(got, base[k])))
    with base_bits(6):
        got = run_logits(cases["float_weights"], cfg, tokens)
    out["control_base_bits_6"] = [max(
        rel(g, w) for g, w in zip(got, base["float_weights"]))]
    return out


# ---------------------------------------------------------------------------
# Op by op, card against CPU.
# ---------------------------------------------------------------------------

#: Ops whose outputs are uninitialized memory: never compared.
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty")


def _snap(x):
    return x.detach().clone().cpu() if isinstance(x, torch.Tensor) else x


class _Recorder(TorchDispatchMode):
    """Every aten op: (func, inputs, outputs), tensors copied to the CPU
    (inputs before the op runs, so in-place ops replay as they ran)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        a, kw = tree_map(_snap, args), tree_map(_snap, kwargs)
        out = func(*args, **kwargs)
        self.ops.append((func, a, kw, tree_map(_snap, out)))
        return out


def _to(dev):
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, torch.device):
            return torch.device(dev)
        return x
    return move


def _diff(got, want) -> float | None:
    """Largest relative difference between two op outputs (None when
    nothing comparable)."""
    worst = None
    for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        if not isinstance(g, torch.Tensor) or not isinstance(w, torch.Tensor):
            continue
        if g.shape != w.shape or g.numel() == 0:
            continue
        if g.dtype.is_floating_point:
            d = rel(g.cpu(), w) if bool(torch.isfinite(w).all()) else float(
                (~torch.isclose(g.cpu(), w, rtol=0, atol=0,
                                equal_nan=True)).sum())
        else:
            d = float((g.cpu() != w).sum())
        worst = d if worst is None else max(worst, d)
    return worst


def _quant_records(rec: list):
    """Wrap ``precision.quantize_values`` to append (x, scale, q)."""
    from repro_torch.core import precision

    orig = precision.quantize_values

    def qv(x, scale, qmax):
        q = orig(x, scale, qmax)
        rec.append((_snap(x), _snap(scale), _snap(q), qmax))
        return q
    return patched(precision, "quantize_values", qv)


def op_by_op(device: str = "cuda") -> dict:
    """The ``ops`` measurement of the module note."""
    from repro_torch.core import precision
    from repro_torch.kernels import build
    from repro_torch.models import transformer

    cfg, params, tokens = reduced_xlstm()
    gp = transformer.params_to(params, device)
    cpu_q, card_q = [], []
    cpu_rec, card_rec = _Recorder(), _Recorder()
    card_tokens = tokens.to(device)
    with torch.inference_mode():
        with _quant_records(cpu_q), cpu_rec:
            want = transformer.forward(params, cfg, {"tokens": tokens})[0]
        with build.plain_versions(), _quant_records(card_q), card_rec:
            got = transformer.forward(gp, cfg, {"tokens": card_tokens})[0]
        kernels = transformer.forward(gp, cfg, {"tokens": card_tokens})[0]
    report = {"forward_rel": rel(got.cpu(), want),
              "kernels_vs_plain_on_card": rel(kernels.cpu(), got.cpu()),
              "n_ops": (len(cpu_rec.ops), len(card_rec.ops)),
              "n_quantizations": (len(cpu_q), len(card_q))}
    # Each op replayed on the card from the CPU's inputs.
    intrinsic, first = {}, None
    for i, (func, args, kwargs, out) in enumerate(cpu_rec.ops):
        name = str(func.overloadpacket.__name__)
        if name in _UNINITIALIZED:
            continue
        try:
            with torch.inference_mode():
                again = func(*tree_map(_to(device), args),
                             **tree_map(_to(device), kwargs))
        except Exception as e:  # an op that cannot replay alone
            intrinsic.setdefault(name, {"n": 0, "max": 0.0,
                                        "error": repr(e)[:120]})
            continue
        d = _diff(again, out)
        if d:
            s = intrinsic.setdefault(name, {"n": 0, "max": 0.0})
            s["n"] += 1
            s["max"] = max(s["max"], d)
            if first is None:
                first = (i, name)
    report["ops_differing_on_identical_inputs"] = intrinsic
    report["first_op_differing_on_identical_inputs"] = first
    # Inherited: the first op whose output differs between the two runs.
    inherited = None
    for i, (a, b) in enumerate(zip(cpu_rec.ops, card_rec.ops)):
        if str(a[0].overloadpacket.__name__) in _UNINITIALIZED:
            continue
        d = _diff(b[3], a[3])
        if d:
            inherited = (i, str(a[0].overloadpacket.__name__), d)
            break
    report["first_op_differing_between_runs"] = inherited
    # The per-tensor quantizations of kom_q_dot.
    qrep = None
    for i, ((x, s, q, qmax), (gx, gs, gq, _)) in enumerate(zip(cpu_q,
                                                               card_q)):
        if torch.equal(s, gs) and torch.equal(q, gq):
            continue
        with torch.inference_mode():
            replay = precision.quantize_values(x.to(device), s.to(device),
                                               qmax).cpu()
        qrep = {"index": i, "shape": tuple(x.shape),
                "input_rel_diff": rel(gx, x),
                "input_bitwise_equal": bool(torch.equal(gx, x)),
                "scale_cpu": float(s.reshape(-1)[0]),
                "scale_card": float(gs.reshape(-1)[0]),
                "integers_differing": int((gq != q).sum()),
                "max_level_change": int((gq - q).abs().max()),
                "card_quantizer_on_cpu_input_equal": bool(
                    torch.equal(replay, q))}
        break
    report["first_quantization_differing"] = qrep
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for k, v in op_by_op(args.device).items():
            print(f"ops {k}: {v}")
    for k, v in ulp_sensitivity(args.device, range(args.seeds)).items():
        print(f"ulp {k}: " + ", ".join(f"{x:.3e}" for x in v)
              + f" (max {max(v):.3e})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
