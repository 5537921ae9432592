"""The port's float path held against the JAX reference, to a tolerance.

``float_split`` must equal the reference bit for bit (both round to
nearest even).  The port's plain versions return each schedule's EXACT
value (limb products are exact, summed in f64, rounded once), so against
the reference's f32 dots they differ by the reference's own accumulation
error alone, ~1e-7 of the largest value at these sizes.  The schedules
themselves lie ~3e-6 apart (bf16x3 against native f32 or bf16x6, bf16x3
against bf16x4), so every kernel-level check holds
``max|port - ref| <= TOL * max|ref|`` with ``TOL = 1e-6`` and, as a
control, requires the plain version of the NEIGHBOURING schedule on the
same inputs to miss that tolerance: a check that passes a wrong schedule
fails here.  Covered: the schedule dots, the bf16-limb GEMM's plain
version against the Pallas ``_bf16_kernel`` in interpret mode, the float
policies in ``policy_linear``, the systolic ``native`` and implicit
``native``/``bf16x3``/``bf16x6`` plain versions against the reference's
mirror and Pallas kernels.

Whole reduced AlexNet/VGG16/VGG19 forwards under ``fp32`` (systolic,
implicit) and ``bf16x6`` (implicit) are held to the same 1e-6 with the
same control (the bf16x3 forward misses it).  Under ``bf16x3`` they are
held to ``FORWARD_TOL_BF16X3 = 1e-5``, which cannot tell bf16x3 from fp32:
bf16x3 is not a smooth function of its inputs at the ulp level -- moving
an input by one f32 ulp can move its low limb by one bf16 ulp (2^7 times
more) -- so a reduced model's bf16x3 logits move by ~1e-6..5e-6 when half
the input pixels move by one ulp, against ~1e-7 under fp32
(``python -m repro_torch.analysis.float_tolerance``; pinned by
``test_bf16x3_amplifies_ulp_noise``), and the ulp-level differences
between two summation orders grow the same way layer after layer.  The
bf16x3 schedule is therefore held at the kernel level, where both sides
see the same inputs.
``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import karatsuba as rkar  # noqa: E402
from repro.core import precision as rprec  # noqa: E402
from repro.core import substrate as rsub  # noqa: E402
from repro.kernels.conv2d import conv2d_implicit as ref_implicit  # noqa: E402
from repro.kernels.conv2d import conv2d_systolic as ref_systolic  # noqa: E402
from repro.kernels.kom_matmul import ops as rkom  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.analysis import float_tolerance  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import karatsuba as pkar  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core import precision as pprec  # noqa: E402
from repro_torch.core import substrate as psub  # noqa: E402
from repro_torch.core import tuning  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conv2d import ops as pops  # noqa: E402
from repro_torch.kernels.kom_matmul import (bf16x3_matmul,  # noqa: E402
                                            bf16x3_matmul_plain)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.serving.cnn_engine import (CNNServeEngine,  # noqa: E402
                                            ImageRequest)
from test_torch_refcache import (cached, cnn_init_numpy,  # noqa: E402
                                 digest, refcache_session)  # noqa: F401

torch.set_num_threads(2)

TOL = 1e-6
FORWARD_TOL_BF16X3 = 1e-5
#: Schedule (passes; 1 = native f32) -> the neighbouring schedule a check
#: must tell it from.
NEIGHBOUR = {1: 3, 3: 1, 4: 3, 6: 3}
VARIANT_OF = {1: "native", 3: "bf16x3", 6: "bf16x6"}
PASSES_OF = {"native": 1, "fp32": 1, "bf16x3": 3, "bf16x6": 6}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert _rel(got, want) <= tol, (_rel(got, want), tol)


def _separates(got, want, neighbour, tol=TOL):
    """``got`` within ``tol`` of ``want``, and the neighbouring schedule's
    plain value on the same inputs not: the check tells the two apart."""
    _close(got, want, tol)
    assert _rel(neighbour, want) > tol, (_rel(neighbour, want), tol)


def _plain_dot(a, b, passes):
    return pkar.schedule_dot(_t(a), _t(b), passes=passes).float().numpy()


def test_float_split_equals_reference_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4000) * 10.0 ** rng.integers(-30, 30, 4000),
        [0.0, -0.0, 1e-40, -3e-39, 3.3895314e38, 1.0 + 2.0 ** -9,
         1.0 + 3 * 2.0 ** -9, -(1.0 + 2.0 ** -8)]]).astype(np.float32)
    for terms in (2, 3):
        want = rkar.float_split(jnp.asarray(x), terms)
        got = pkar.float_split(_t(x), terms)
        assert len(got) == terms
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g.to(torch.float32).numpy(),
                np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("passes", [1, 3, 4, 6])
def test_bf16xn_dot_general_matches_reference(passes):
    """The schedule dots against the reference's (``passes=1``: its full-f32
    dot), and the schedules' own accuracy against exact f32 inputs."""
    rng = np.random.default_rng(passes)
    a = (rng.standard_normal((3, 17, 130)) * 5).astype(np.float32)
    b = rng.standard_normal((130, 45)).astype(np.float32)
    if passes == 1:
        want = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b),
                                     precision=jax.lax.Precision.HIGHEST))
        got = _plain_dot(a, b, 1)
    else:
        want = np.asarray(rkar.bf16xn_dot_general(
            jnp.asarray(a), jnp.asarray(b), (((2,), (0,)), ((), ())),
            passes=passes))
        got = pkar.bf16xn_dot_general(_t(a), _t(b), passes=passes).numpy()
        np.testing.assert_array_equal(got, _plain_dot(a, b, passes))
    _separates(got, want, _plain_dot(a, b, NEIGHBOUR[passes]))
    exact = a.astype(np.float64) @ b
    err = np.abs(want - exact).max() / np.abs(exact).max()
    assert err < (1e-5 if passes in (3, 4) else 1e-6)


@pytest.mark.parametrize("passes", [3, 4, 6])
def test_bf16_gemm_plain_matches_reference(passes):
    """The bf16-limb GEMM's plain version (what a CPU tensor runs) against
    the Pallas ``_bf16_kernel`` in interpret mode (passes 3 and 4) and
    ``bf16xn_dot_general`` (passes 6, the bf16x6 FC layers)."""
    rng = np.random.default_rng(10 + passes)
    a = rng.standard_normal((9, 300)).astype(np.float32)
    b = (rng.standard_normal((300, 70)) * 1e-2).astype(np.float32)
    if passes == 6:
        want = rkar.bf16xn_dot_general(jnp.asarray(a), jnp.asarray(b),
                                       passes=6)
    else:
        want = rkom.bf16x3_matmul(jnp.asarray(a), jnp.asarray(b),
                                  passes=passes, interpret=True)
    before = build.launch_counts()
    got = bf16x3_matmul(_t(a), _t(b), passes=passes)
    assert build.launch_counts() == before
    assert torch.equal(got, bf16x3_matmul_plain(_t(a), _t(b), passes=passes))
    _separates(got.numpy(), np.asarray(want),
               _plain_dot(a, b, NEIGHBOUR[passes]))
    with pytest.raises(ValueError):
        bf16x3_matmul(_t(a), _t(b), passes=5)


@pytest.mark.parametrize("policy", ["bf16x3", "bf16x6", "fp32"])
def test_policy_linear_float_policies_match_reference(policy):
    """FC layers under the float policies, a cached QWeight dequantized
    first; the integer policies on float weights run their forward and
    refuse gradients."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 3, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) * 0.1).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    rq = rsub.quantize_weight(jnp.asarray(w))
    pq = psub.quantize_weight(_t(w))
    other = {"fp32": "bf16x3", "bf16x3": "fp32", "bf16x6": "bf16x3"}[policy]
    for rw, pw in ((jnp.asarray(w), _t(w)), (rq, pq)):
        want = np.asarray(rprec.policy_linear(jnp.asarray(x), rw,
                                              policy=policy)) + b
        got = pprec.policy_linear(_t(x), pw, policy=policy, bias=_t(b))
        neighbour = pprec.policy_linear(_t(x), pw, policy=other, bias=_t(b))
        _separates(got.numpy(), want, neighbour.numpy())
    # integer policies on float weights: the forward is the eager
    # reference's per-tensor product bit for bit; gradients are not ported
    np.testing.assert_array_equal(
        pprec.policy_linear(_t(x), _t(w), policy="kom_int14").numpy(),
        np.asarray(rprec.policy_linear(jnp.asarray(x), jnp.asarray(w),
                                       policy="kom_int14")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pprec.policy_linear(_t(x).requires_grad_(), _t(w),
                            policy="kom_int14")


# (n, h, cin, k, cout, stride, padding)
CASES = [
    (2, 9, 5, 3, 7, 1, "SAME"),
    (2, 11, 4, 5, 6, 2, "VALID"),
    (1, 19, 3, 11, 5, 4, "VALID"),
    (2, 12, 24, 3, 16, 1, "SAME"),
]


@pytest.mark.parametrize("case", CASES)
def test_systolic_native_matches_reference_interpret(case):
    n, h, cin, k, cout, s, pad = case
    rng = np.random.default_rng(h + k)
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    kw = dict(stride=s, padding=pad, activation="relu")
    want = np.asarray(ref_systolic(jnp.asarray(x), jnp.asarray(w),
                                   bias=jnp.asarray(b), interpret=True,
                                   variant="native", **kw))
    got = pops.conv2d_systolic(_t(x), _t(w), bias=_t(b), variant="native",
                               **kw)
    neighbour = pops.conv2d_implicit(_t(x), _t(w), bias=_t(b),
                                     variant="bf16x3", **kw)
    _separates(got.numpy(), want, neighbour.numpy())


@pytest.mark.parametrize("variant", ["native", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("case", CASES)
def test_implicit_float_matches_reference(variant, case):
    """The float implicit plain version against the reference's streamed
    mirror (``use_pallas=False``) and its Pallas kernel in interpret mode
    (not for the 11x11 stem: 121 interpreted taps take seconds per pass);
    a QWeight is dequantized first on both sides."""
    n, h, cin, k, cout, s, pad = case
    rng = np.random.default_rng(h * k + cin)
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    kw = dict(stride=s, padding=pad, variant=variant, activation="relu")
    other = dict(kw, variant=VARIANT_OF[NEIGHBOUR[PASSES_OF[variant]]])
    got = pops.conv2d_implicit(_t(x), _t(w), bias=_t(b), **kw).numpy()
    neighbour = pops.conv2d_implicit(_t(x), _t(w), bias=_t(b),
                                     **other).numpy()
    for use_pallas in (False, True)[:1 if k == 11 else 2]:
        want = np.asarray(ref_implicit(
            jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
            use_pallas=use_pallas, interpret=True, **kw))
        _separates(got, want, neighbour)
    qw = psub.quantize_weight(_t(w))
    want_q = np.asarray(ref_implicit(
        jnp.asarray(x), rsub.quantize_weight(jnp.asarray(w)),
        bias=jnp.asarray(b), use_pallas=False, **kw))
    _separates(pops.conv2d_implicit(_t(x), qw, bias=_t(b), **kw).numpy(),
               want_q,
               pops.conv2d_implicit(_t(x), qw, bias=_t(b), **other).numpy())


def test_implicit_float_pools_after_the_core():
    """pool= on a float variant pools after the core, bias and ReLU on the
    pooled map, as the reference's mirror does off the TPU."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 10, 10, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 6)) * 0.1).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    kw = dict(variant="bf16x3", activation="relu", pool=(2, 2, "VALID"))
    want = np.asarray(ref_implicit(jnp.asarray(x), jnp.asarray(w),
                                   bias=jnp.asarray(b), use_pallas=False,
                                   **kw))
    got = pops.conv2d_implicit(_t(x), _t(w), bias=_t(b), **kw)
    neighbour = pops.conv2d_implicit(_t(x), _t(w), bias=_t(b),
                                     **dict(kw, variant="native"))
    _separates(got.numpy(), want, neighbour.numpy())


# ---------------------------------------------------------------------------
# Whole models under the float policies, every conv on one engine.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    ref_cfg = ref_reduced(ref_get_config(arch))
    params = cnn_init_numpy(ref_cfg, 0)
    rng = np.random.default_rng(0)
    for p in params:
        if "b" in p:
            p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(
                np.float32)
    x = rng.standard_normal((2, ref_cfg.img_size, ref_cfg.img_size,
                             3)).astype(np.float32)
    return params, x


@functools.lru_cache(maxsize=None)
def _ref_logits(arch, policy, path):
    """``jax.jit(cnn_forward)`` of the reference, once per run
    (``test_torch_refcache``): each case that must be told apart from the
    bf16x3 logits reads them."""
    params, x = _ref_params(arch)
    ref_cfg = ref_reduced(ref_get_config(arch)).replace(
        policy=rprec.MatmulPolicy(policy), conv_path=path)
    return cached("float-logits", (arch, policy, path, digest(params, x)),
                  lambda: np.asarray(jax.jit(lambda p, v: ref_cnn.cnn_forward(
                      p, ref_cfg, v))([{k: jnp.asarray(v)
                                        for k, v in p.items()}
                                       for p in params], jnp.asarray(x))))


@pytest.mark.parametrize("policy,path", [("fp32", "systolic"),
                                         ("fp32", "implicit"),
                                         ("bf16x3", "implicit"),
                                         ("bf16x6", "implicit")])
@pytest.mark.parametrize("arch", ["alexnet", "vgg16", "vgg19"])
def test_float_models_match_jitted_reference(arch, policy, path):
    params, x = _ref_params(arch)
    want = _ref_logits(arch, policy, path)
    cfg = reduced(get_config(arch)).replace(
        policy=pprec.MatmulPolicy(policy), conv_path=path)
    got = cnn.cnn_forward(params_from_numpy(params, device="cpu"), cfg,
                          torch.from_numpy(x)).numpy()
    if policy == "bf16x3":
        _close(got, want, FORWARD_TOL_BF16X3)
    else:
        _separates(got, want, _ref_logits(arch, "bf16x3", "implicit"))


@pytest.mark.parametrize("k", [1, 37, 1023, 1024, 1025, 2000, 4096, 25088,
                               25093])
def test_bf16_gemm_split_k_groups_tile_k(k):
    """The bf16-limb GEMM kernel's K groups (one block group each) tile K
    with no gap or overlap, start on the nested-sum group's boundaries,
    and only the last one is short; the per-group sums get an f32 scratch
    (groups, m, n padded to 4) exactly when there is more than one."""
    from repro_torch.kernels.kom_matmul.ops import (BF16_GROUP_K,
                                                    BF16_MIN_GROUP_K,
                                                    BF16_TILE_K, bf16_split_k)
    for m, n in ((8, 130), (1, 4096), (8, 4096), (20, 1000)):
        plan = bf16_split_k(m, k, n)
        bounds, group = plan["bounds"], plan["group_k"]
        assert group in (BF16_GROUP_K, BF16_GROUP_K // 2, BF16_MIN_GROUP_K)
        assert group % BF16_TILE_K == 0
        assert len(bounds) == -(-k // group)
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(bounds, bounds[1:]))
        assert all(k0 % group == 0 and 0 < k1 - k0 <= group
                   for k0, k1 in bounds)
        assert all(k1 - k0 == group for k0, k1 in bounds[:-1])
        n4 = -(-n // 4) * 4
        assert plan["n4"] == n4
        assert plan["scratch"] == ((len(bounds), m, n4) if len(bounds) > 1
                                   else None)
    with pytest.raises(ValueError):
        bf16_split_k(0, k, 130)


def test_bf16_gemm_split_k_group_follows_the_grid():
    """VGG16's fc6 (K 25088, N 4096) already gives 800 blocks at the full
    1024-entry group; fc7 and fc8 halve it, down to 256, for more blocks."""
    from repro_torch.kernels.kom_matmul.ops import bf16_split_k
    assert bf16_split_k(8, 25088, 4096)["group_k"] == 1024
    assert bf16_split_k(8, 4096, 4096)["group_k"] == 256
    assert bf16_split_k(8, 4096, 1000)["group_k"] == 256
    assert bf16_split_k(1, 25088, 4096)["group_k"] == 1024


def _split_k_sums(a, b, passes, group):
    """The CUDA kernel's f32 sums in its own order (csrc/bf16_matmul.cu):
    per K group of ``group`` entries, 8 K lanes (lane q takes entries q, q + 8, q + 16, q + 24
    of each 32-entry tile) each add a tile's pass terms into a partial,
    the partial into the lane's sum; the lanes, then the groups, are added
    in order.  A bf16 x bf16 product is exact in f32, so ``s + p`` here is
    the kernel's ``__fmaf_rn``."""
    from repro_torch.kernels.kom_matmul.ops import BF16_TILE_K
    limbs, pairs = pkar.BF16XN_SCHEDULES[passes]
    la, lb = ([t.float() for t in pkar.float_split(x, limbs)] for x in (a, b))
    m, k = a.shape
    n, lanes = b.shape[1], 8
    out = None
    for g0 in range(0, k, group):
        g1 = min(k, g0 + group)
        acc = torch.zeros((lanes, m, n))
        for t0 in range(g0, g1, BF16_TILE_K):
            part = torch.zeros((lanes, m, n))
            for e in range(BF16_TILE_K // lanes):
                ks = t0 + torch.arange(lanes) + lanes * e
                ok = (ks < g1)[:, None, None]
                ks = ks.clamp(max=k - 1)
                for i, j in pairs:
                    prod = la[i][:, ks].T[:, :, None] * lb[j][ks][:, None, :]
                    part = torch.where(ok, part + prod, part)
            acc = acc + part
        gsum = acc[0]
        for q in range(1, lanes):
            gsum = gsum + acc[q]
        out = gsum if out is None else out + gsum
    return out


@pytest.mark.parametrize("group", [256, 1024])
@pytest.mark.parametrize("passes", [3, 6])
def test_bf16_gemm_split_k_sums_stay_within_float_tol(passes, group):
    """The kernel's nested f32 sums (emulated above) at fc6's K = 25088,
    at the smallest and the largest group: within TOL of the schedule's
    exact value, which the neighbouring schedule misses -- the design keeps
    the kernel checkable."""
    g = torch.Generator().manual_seed(passes)
    a = torch.relu(torch.randn((8, 25088), generator=g))
    b = torch.randn((25088, 24), generator=g) * 25088 ** -0.5
    got = _split_k_sums(a, b, passes, group)
    want = pkar.schedule_dot(a, b, passes=passes)
    assert _rel(got, want) <= TOL, _rel(got, want)
    other = pkar.schedule_dot(a, b, passes={3: 1, 6: 3}[passes])
    assert _rel(other, want) > TOL, _rel(other, want)


def test_bf16x3_amplifies_ulp_noise():
    """Why whole bf16x3 forwards get the looser 1e-5: one-ulp input noise
    moves their logits past the 1e-6 that fp32 and bf16x6 stay far
    within."""
    moves = float_tolerance.ulp_sensitivity("alexnet")
    assert moves["bf16x3"] > TOL
    assert max(moves["fp32"], moves["bf16x6"]) < TOL / 5
    assert moves["bf16x3"] <= FORWARD_TOL_BF16X3


def test_bf16x3_engine_and_launcher_serve_on_cpu(capsys):
    """CNNServeEngine under bf16x3 on the implicit engine: float params
    served as they are, batch-invariant logits; the launcher's flags."""
    cfg = reduced(get_config("vgg16")).replace(
        policy=pprec.MatmulPolicy.BF16X3, conv_path="implicit")
    params = cnn.cnn_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    eng = CNNServeEngine(cfg, params, buckets=(4,), device="cpu")
    assert not any(isinstance(p.get("w"), psub.QWeight) for p in eng.params)
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    for uid, img in enumerate(imgs):
        eng.submit(ImageRequest(uid=uid, image=img))
    done = eng.run()
    assert sorted(done) == [0, 1, 2]
    for uid, img in enumerate(imgs):
        solo = eng.forward(torch.from_numpy(img[None])).numpy()[0]
        np.testing.assert_array_equal(done[uid].logits, solo)
    from repro_torch.launch.serve import main
    assert main(["--arch", "alexnet", "--reduced", "--device", "cpu",
                 "--requests", "2", "--buckets", "2", "--policy", "bf16x6",
                 "--conv-path", "implicit"]) == 0
    assert "alexnet/bf16x6/implicit on cpu" in capsys.readouterr().out


def test_cost_rows_for_the_systolic_engine_and_float_variants(monkeypatch):
    geo = dict(kh=3, kw=3, stride=1, h=56, cin=256, cout=256)
    mults = 56 * 56 * 9 * 256 * 256
    for variant, passes, peak in (("karatsuba", 3, 1979e12),
                                  ("bf16x3", 3, 989e12),
                                  ("bf16x6", 6, 989e12),
                                  ("native_bf16", 1, 989e12),
                                  ("native", 1, 67e12)):
        r = roofline.conv_layer_roofline("implicit", variant=variant, **geo)
        assert r["compute_s"] == pytest.approx(2 * mults * passes / peak)
    s_int = tuning.conv_hbm_bytes("systolic", variant="karatsuba", **geo)
    s_f32 = tuning.conv_hbm_bytes("systolic", variant="native", **geo)
    assert s_int < s_f32  # int16 re-reads and int16 weights
    assert tuning.conv_hbm_bytes("systolic", variant="native", **geo) == \
        tuning.conv_hbm_bytes("implicit", variant="native", **geo)
    r = roofline.conv_layer_roofline("systolic", variant="karatsuba", **geo)
    assert r["memory_s"] == pytest.approx(s_int / 3.35e12)
    # The explorer prices each float policy's products at their own type.
    seen = []
    real = roofline.conv_layer_roofline

    def spy(path, **kw):
        seen.append(kw["variant"])
        return real(path, **kw)

    monkeypatch.setattr(roofline, "conv_layer_roofline", spy)
    cfg = reduced(get_config("vgg16"))
    for policy in ("native_bf16", "fp32", "bf16x3"):
        seen.clear()
        planner.explore(cfg.replace(policy=pprec.MatmulPolicy(policy)),
                        model_only=True)
        assert set(seen) == {"native" if policy == "fp32" else policy}
    with pytest.raises(ValueError):
        tuning.conv_hbm_bytes("systolic", variant="karatsuba",
                              fusion="pool", **geo)
