"""The port's fused dataflow against the JAX reference, on the CPU.

The implicit kernel's pooled epilogue and its ``pool_quant`` handoff: the
plain versions equal the reference's interpret-mode Pallas kernel and lax
mirrors at tolerance 0, ``handoff_quantize`` gives the reference's int16
values and power-of-two cell grid, and reduced AlexNet / VGG16 / VGG19
under the plan the REFERENCE's ``explore(model_only=True, requant=True)``
returns give ``jax.jit(cnn_forward(..., fuse=True))``'s logits bit for bit
(and ``fuse=False``'s under ``fuse=False``), under both integer policies,
through ``cnn_forward`` and the serving engine.  Then the port's own
explorer, cost models, artifacts, launcher flags and the degrade reroute
under a ``pool_quant`` plan.  Inputs come from numpy with fixed seeds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import planner as ref_planner  # noqa: E402
from repro.core import substrate as ref_sub  # noqa: E402
from repro.core.precision import MatmulPolicy as RefPolicy  # noqa: E402
from repro.core.systolic import pool2d as ref_pool2d  # noqa: E402
from repro.kernels.conv2d import handoff_quantize as ref_handoff  # noqa: E402
from repro.kernels.conv2d.ops import \
    conv2d_implicit as ref_conv2d_implicit  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import planner, tuning  # noqa: E402
from repro_torch.core import substrate as sub  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.core.systolic import pool2d  # noqa: E402
from repro_torch.kernels.conv2d import ops  # noqa: E402
from repro_torch.kernels.conv2d.implicit_gemm import \
    conv2d_implicit_handoff_raw  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.serving.cnn_engine import (CNNServeEngine,  # noqa: E402
                                            ImageRequest)
from repro_torch.serving.scheduler import RetryPolicy  # noqa: E402
from test_torch_refcache import (cnn_init_numpy,  # noqa: E402
                                 refcache_session)  # noqa: F401

torch.set_num_threads(2)

SPECS = [("karatsuba", 7), ("schoolbook", 8)]
POLICIES = ["kom_int14", "schoolbook_int16"]


def _case(h, cin, cout, *, k=3, n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    return x, w, b


def _weights(w, base_bits):
    """The same per-channel weight quantization on both sides (the port's
    weight scale is the reference's eager true division)."""
    rq = ref_sub.quantize_weight(jnp.asarray(w), base_bits=base_bits)
    pq = sub.quantize_weight(torch.from_numpy(w), base_bits=base_bits)
    np.testing.assert_array_equal(pq.values.numpy(), np.asarray(rq.values))
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(rq.scale))
    return rq, pq


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the pooled epilogue ------------------------------------------------------

@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("h,pool,block", [
    (12, (2, 2, "VALID"), (4, 128, 8)),
    (21, (3, 2, "VALID"), (4, 128, 16)),   # the reference's seam case
    (17, (2, 2, "SAME"), (4, 128, 16)),    # SAME: pooled after the core
])
def test_pooled_plain_equals_reference_pallas_interpret(variant, base_bits,
                                                        h, pool, block):
    x, w, b = _case(h, cin=16, cout=16, n=1)
    rq, pq = _weights(w, base_bits)
    kw = dict(stride=1, padding="SAME", variant=variant, block=block,
              activation="relu", pool=pool)
    want = ref_conv2d_implicit(jnp.asarray(x), rq, bias=jnp.asarray(b),
                               use_pallas=True, interpret=True, **kw)
    got = ops.conv2d_implicit(torch.from_numpy(x), pq, bias=_t(b), **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("h,k,stride,cin", [(27, 5, 1, 24), (9, 3, 1, 16),
                                            (16, 3, 2, 16)])
def test_pooled_plain_equals_jitted_reference(variant, base_bits, h, k,
                                              stride, cin):
    """Odd maps (AlexNet conv2's 27 -> 13), strided convs: the pooled layer
    under ``jax.jit`` is ``max(fl(raw * t)) + b``, then ReLU."""
    x, w, b = _case(h, cin=cin, cout=24, k=k, seed=h)
    rq, pq = _weights(w, base_bits)
    kw = dict(stride=stride, padding="SAME", variant=variant,
              activation="relu", pool=(2, 2))
    want = jax.jit(lambda a: ref_conv2d_implicit(
        a, rq, bias=jnp.asarray(b), use_pallas=False, **kw))(jnp.asarray(x))
    got = ops.conv2d_implicit(torch.from_numpy(x), pq, bias=_t(b), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pool2d_same_matches_reference():
    x = np.arange(2 * 5 * 5 * 3, dtype=np.float32).reshape(2, 5, 5, 3) - 40
    for window, stride in ((2, 2), (3, 2), (3, 1)):
        want = ref_pool2d(jnp.asarray(x), window=window, stride=stride,
                          kind="max", padding="SAME")
        got = pool2d(torch.from_numpy(x), window=window, stride=stride,
                     kind="max", padding="SAME")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the handoff --------------------------------------------------------------

@pytest.mark.parametrize("base_bits", [7, 8])
@pytest.mark.parametrize("h", [12, 9, 2])
def test_handoff_quantize_matches_reference(base_bits, h):
    x, _, _ = _case(h, cin=16, cout=1, seed=h)
    x = np.maximum(x, 0) * 3.0
    x[0, : h // 2, : h // 2] = 0.0           # an all-zero cell region
    want = ref_handoff(jnp.asarray(x), base_bits=base_bits)
    got = ops.handoff_quantize(torch.from_numpy(x), base_bits=base_bits)
    assert got.shape == want.shape == x.shape
    assert (got.h, got.w, got.base_bits) == (h, h, base_bits)
    assert got.values.dtype == torch.int16
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    mant, _ = np.frexp(got.scale.numpy())
    np.testing.assert_array_equal(mant, np.full_like(mant, 0.5))
    assert np.abs(got.values.numpy()).max() <= sub.kom_qmax(base_bits)


@pytest.mark.parametrize("variant,base_bits", SPECS)
@pytest.mark.parametrize("h,cin,bk", [(8, 24, 8), (9, 24, 16), (6, 40, 40)])
def test_handoff_consumer_plain_equals_reference(variant, base_bits, h, cin,
                                                 bk):
    """The consumer's per-(chunk, tap) recombine-and-scale order: equal to
    the reference's lax mirror (eager, no bias: ``acc * s_ch``) and, with a
    bias, to the jitted layer (``fma(acc, s_ch, b)``)."""
    x, w, b = _case(h, cin=cin, cout=16, seed=cin)
    rq, pq = _weights(w, base_bits)
    xr = ref_handoff(jnp.maximum(jnp.asarray(x), 0), base_bits=base_bits)
    xp = ops.handoff_quantize(torch.relu(torch.from_numpy(x)),
                              base_bits=base_bits)
    kw = dict(variant=variant, block=(8, 128, bk))
    want = ref_conv2d_implicit(xr, rq, use_pallas=False, **kw)
    got = ops.conv2d_implicit(xp, pq, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.jit(lambda q: ref_conv2d_implicit(
        q, rq, bias=jnp.asarray(b), activation="relu", use_pallas=False,
        **kw))(xr)
    got = ops.conv2d_implicit(xp, pq, bias=_t(b), activation="relu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant,base_bits", SPECS)
def test_handoff_consumer_plain_equals_reference_pallas_interpret(
        variant, base_bits):
    x, w, _ = _case(8, cin=16, cout=16, n=1, seed=4)
    rq, pq = _weights(w, base_bits)
    xr = ref_handoff(jnp.asarray(x), base_bits=base_bits)
    want = ref_conv2d_implicit(xr, rq, variant=variant, block=(4, 128, 8),
                               use_pallas=True, interpret=True)
    got = conv2d_implicit_handoff_raw(
        _t(xr.values), _t(xr.scale), pq.values, pq.scale, bk=8,
        variant=variant, base_bits=base_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_conv_legality_matches_reference():
    """Only the implicit engine pools or quantizes, and a QActivation input
    is a cached-QWeight 3x3/s1/SAME integer contract -- raised as the
    reference raises."""
    x, w, _ = _case(8, cin=16, cout=16)
    _, pq = _weights(w, 7)
    xt = torch.from_numpy(x)
    qa = ops.handoff_quantize(xt, base_bits=7)
    for path in ("winograd", "im2col"):
        with pytest.raises(ValueError, match="epilogue"):
            sub.conv2d(xt, pq, policy="kom_int14", path=path, pool=(2, 2))
    with pytest.raises(ValueError, match="QActivation"):
        sub.conv2d(qa, pq, policy="kom_int14", path="winograd")
    with pytest.raises(ValueError, match="cached QWeight"):
        ops.conv2d_implicit(qa, torch.from_numpy(w))
    with pytest.raises(ValueError, match="3x3/s1/SAME"):
        ops.conv2d_implicit(qa, pq, stride=2)
    _, pq8 = _weights(w, 8)
    with pytest.raises(ValueError, match="base_bits"):
        ops.conv2d_implicit(qa, pq8, variant="schoolbook")
    out = sub.conv2d(qa, pq, policy="kom_int14", path="auto")
    assert tuple(out.shape) == (2, 8, 8, 16)


# -- whole models under the reference's requant plan --------------------------

def _model_case(arch, policy, seed=0):
    ref_cfg = ref_reduced(ref_get_config(arch)).replace(
        policy=RefPolicy(policy))
    cfg = reduced(get_config(arch)).replace(policy=MatmulPolicy(policy))
    params = cnn_init_numpy(ref_cfg, seed)
    rng = np.random.default_rng(seed)
    for p in params:
        if "b" in p:
            p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(
                np.float32)
    x = rng.standard_normal(
        (2, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)
    qr = ref_cnn.cnn_quantize_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params], ref_cfg)
    qp = cnn.cnn_quantize_params(params_from_numpy(params, device="cpu"),
                                 cfg)
    return ref_cfg, cfg, params, qr, qp, x


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["alexnet", "vgg16", "vgg19"])
def test_model_logits_equal_jitted_reference_under_requant_plan(arch,
                                                                policy):
    ref_cfg, cfg, params, qr, qp, x = _model_case(arch, policy)
    ref_plan = ref_planner.explore(ref_cfg, model_only=True, requant=True,
                                   backend="cpu")
    plan = planner.ExecutionPlan.from_json(ref_plan.to_json(),
                                           backend="cpu")
    fusions = [e.fusion for e in plan.entries]
    assert "pool_quant" in fusions and "pool" in fusions, fusions
    for fuse in (True, False):
        want = np.asarray(jax.jit(lambda p, v: ref_cnn.cnn_forward(
            p, ref_cfg, v, plan=ref_plan, fuse=fuse))(qr, jnp.asarray(x)))
        got = cnn.cnn_forward(qp, cfg, torch.from_numpy(x), plan=plan,
                              fuse=fuse).numpy()
        assert got.shape == (2, cfg.n_classes)
        np.testing.assert_array_equal(got, want)
        if fuse:
            fused = got
    eng = CNNServeEngine(cfg, params_from_numpy(params, device="cpu"),
                         buckets=(2,), device="cpu", plan=plan)
    for uid in range(2):
        eng.submit(ImageRequest(uid=uid, image=x[uid]))
    done = eng.run()
    for uid in range(2):
        np.testing.assert_array_equal(done[uid].logits, fused[uid])


def test_degrade_reroute_under_pool_quant_plan_equals_reference_fallback():
    """OOM-shaped failures reroute a pool_quant plan to the materialized
    fallback: the degraded logits equal the reference's degraded forward
    (not, in general, the healthy handoff-quantized ones)."""
    ref_cfg, cfg, params, qr, _, x = _model_case("vgg16", "schoolbook_int16",
                                                 seed=1)
    ref_plan = ref_planner.explore(ref_cfg, model_only=True, requant=True,
                                   backend="cpu")
    plan = planner.ExecutionPlan.from_json(ref_plan.to_json(),
                                           backend="cpu")
    ref_fb = ref_planner.materialized_fallback_plan(ref_plan)
    fb = planner.materialized_fallback_plan(plan)
    assert fb.to_json() == ref_fb.to_json()
    assert {e.fusion for e in fb.entries} == {"bias_relu"}
    want = np.asarray(jax.jit(lambda p, v: ref_cnn.cnn_forward(
        p, ref_cfg, v, plan=ref_fb))(qr, jnp.asarray(x)))
    eng = CNNServeEngine(cfg, params_from_numpy(params, device="cpu"),
                         buckets=(1, 2), device="cpu", plan=plan,
                         retry=RetryPolicy(max_attempts=4))
    real_forward, fails = eng.forward, [2]

    def flaky(v):
        if fails[0]:
            fails[0] -= 1
            raise RuntimeError("CUDA out of memory (injected)")
        return real_forward(v)

    eng.forward = flaky
    for uid in range(2):
        eng.submit(ImageRequest(uid=uid, image=x[uid]))
    done = eng.run()
    assert eng.degrade_log == ["dropped bucket 2",
                               "rerouted plan to materialized im2col"]
    assert eng.plan == fb
    for uid in range(2):
        np.testing.assert_array_equal(done[uid].logits, want[uid])


# -- the port's explorer, cost models, artifacts and launcher ----------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["vgg16", "alexnet"])
def test_explore_fuses_exactly_where_the_topology_allows(arch, policy,
                                                         monkeypatch):
    """Full size: pool on every pool-followed implicit layer, pool_quant
    where it also feeds a 3x3/s1 consumer, and the reference's paths and
    fusions.  The Cin chunk is the port's own (the whole Cin: one
    recombine per tap); the reference's TPU tile model may split it."""
    cfg = get_config(arch, policy=MatmulPolicy(policy))
    plan = planner.explore(cfg, model_only=True, requant=True)
    assert plan.backend == "cuda"
    assert {e.source for e in plan.entries} == {"model"}
    by_key = plan.by_key
    keys = ("kh", "kw", "stride", "h", "cin", "cout", "padding")
    for t in cnn.cnn_layer_topology(cfg):
        e = by_key[planner.geometry_key(**{k: t[k] for k in keys})]
        assert e.path == ("implicit" if t["cin"] >= 16 else "im2col")
        if t["pool_after"] and e.path == "implicit":
            assert e.fusion == ("pool_quant" if t["handoff_next"]
                                else "pool")
        if e.path == "implicit":
            assert e.block[2] == t["cin"]
    ref_plan = ref_planner.explore(
        ref_get_config(arch).replace(policy=RefPolicy(policy)),
        model_only=True, requant=True, backend="cpu")
    assert [(e.key, e.path, e.fusion) for e in plan.entries] == \
        [(e.key, e.path, e.fusion) for e in ref_plan.entries]
    plain = planner.explore(cfg, model_only=True)
    assert "pool_quant" not in {e.fusion for e in plain.entries}
    if arch == "vgg16":
        fusions = [e.fusion for e in plan.entries]
        assert fusions.count("pool_quant") == 4 and fusions[-1] == "pool"
    # Measured exploration, under a patched timer (no conv runs): every
    # layer scored by its wall, source="measured".
    from repro_torch.core import tuning
    monkeypatch.setattr(tuning, "_time_call", lambda fn, *a, **k: 7.0)
    measured = planner.explore(cfg, model_only=False, device="cpu",
                               tune_tiles=False)
    assert {e.source for e in measured.entries} == {"measured"}
    assert {e.est_us for e in measured.entries} == {7.0}


def test_cost_models_count_like_the_reference_and_price_the_fusions():
    geo = dict(kh=3, kw=3, stride=1, h=56, cin=256, cout=256)
    for path in ("im2col", "implicit", "winograd"):
        assert roofline.conv_mult_counts(path, n=2, **geo) == \
            ref_roofline.conv_mult_counts(path, n=2, **geo)
    kw = dict(variant="karatsuba", **geo)
    by = {f: tuning.conv_hbm_bytes("implicit", fusion=f, **kw)
          for f in ("none", "bias_relu", "pool", "pool_quant")}
    assert by["pool"] < by["bias_relu"] < by["none"]
    assert by["pool"] < by["pool_quant"] < by["bias_relu"]
    assert tuning.conv_hbm_bytes("implicit", handoff_in=True, **kw) < \
        by["bias_relu"]
    r = roofline.conv_layer_roofline("implicit", **kw)
    assert r["compute_s"] == pytest.approx(
        2 * 56 * 56 * 9 * 256 * 256 * 3 / 1979e12)
    assert r["memory_s"] == pytest.approx(by["bias_relu"] / 3.35e12)
    assert r["roofline_s"] == max(r["compute_s"], r["memory_s"])
    with pytest.raises(ValueError):
        tuning.conv_hbm_bytes("unknown", **kw)


def test_plan_artifacts_round_trip_and_refuse_foreign_stamps(tmp_path):
    cfg = get_config("vgg16", policy=MatmulPolicy.KOM_INT14)
    plan = planner.explore(cfg, model_only=True, requant=True)
    other = planner.explore(cfg.replace(policy=MatmulPolicy.SCHOOLBOOK_INT16),
                            model_only=True, requant=True)
    path = tmp_path / "cuda.json"
    planner.save_plans([plan], path)
    planner.save_plans([other], path)      # merges
    got = planner.load_plans(path, backend="cuda")
    assert got[planner.plan_key("vgg16", "kom_int14")] == plan
    assert got[planner.plan_key("vgg16", "schoolbook_int16")] == other
    with pytest.raises(planner.PlanArtifactError):
        planner.load_plans(path, backend="cpu")
    stale = tmp_path / "stale.json"
    stale.write_text('{"schema": "execution-plan/v0", "backend": "cuda"}')
    with pytest.raises(planner.PlanArtifactError):
        planner.load_plans(stale)
    with pytest.raises(ValueError):
        planner.save_plans([plan, dataclasses.replace(other,
                                                      backend="cpu")], path)
    assert planner.plans_dir().parts[-3:] == ("repro_torch", "tuned",
                                              "plans")


def test_serve_launcher_explore_and_plan_flags(capsys, tmp_path):
    from repro_torch.launch.serve import main

    base = ["--arch", "vgg16", "--reduced", "--device", "cpu", "--requests",
            "2", "--buckets", "1,2", "--policy", "schoolbook_int16"]
    assert main(base + ["--explore", "--model-only", "--requant"]) == 0
    out = capsys.readouterr().out
    assert "fusion=pool_quant" in out and "2 images" in out
    cfg = reduced(get_config("vgg16",
                             policy=MatmulPolicy.SCHOOLBOOK_INT16))
    path = planner.save_plans([planner.explore(
        cfg, model_only=True, requant=True, backend="cpu")],
        tmp_path / "cpu.json")
    assert main(base + ["--plan", str(path)]) == 0
    assert "fusion=pool_quant" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(base + ["--requant"])
