"""The port's planning layer on the CPU: measured explorer, tile tuner,
plan checks, traffic model, roofline annotation, engine quantization.

No conv runs here: the measured explorer and the tuner are driven through
patched timers (``planner._measure_paths``, ``tuning._time_call``), so the
whole file takes seconds.  The walls a card gives are the card's business
(``chip_smoke.py``); what is held here is what the port does with them --
against the reference's ``explore`` fed the same walls -- and the
artifacts, caches and byte counts around it.
"""
import dataclasses
import json
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import traffic as ref_traffic  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import planner as ref_planner  # noqa: E402
from repro.core.precision import MatmulPolicy as RefPolicy  # noqa: E402
from repro.serving.cnn_engine import CNNServeEngine as RefEngine  # noqa: E402
from repro_torch.analysis import traffic  # noqa: E402
from repro_torch.analysis.roofline import (annotate_plan,  # noqa: E402
                                           conv_layer_roofline)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import planner, substrate, tuning  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.serving.cnn_engine import CNNServeEngine  # noqa: E402

POLICIES = ["kom_int14", "schoolbook_int16"]
_COMPARED = ("key", "path", "fusion", "source", "est_us", "exactness_bound")


def _walls(paths, *, kh, kw, stride, h, cin, cout, padding, **_):
    """Deterministic fake walls per (layer, engine): (us, fused, unfused),
    the unfused call faster on some layers (fusion "none")."""
    out = {}
    for p in paths:
        seed = zlib.crc32(f"{p}|{kh}|{stride}|{h}|{cin}|{cout}|{padding}"
                          .encode())
        rng = np.random.default_rng(seed)
        fused = float(np.round(rng.uniform(10, 1000), 3))
        unfused = float(np.round(fused * rng.uniform(0.9, 1.3), 3))
        out[p] = (min(fused, unfused), fused, unfused)
    return out


def _pair(arch, policy, small):
    ref_cfg = ref_get_config(arch).replace(policy=RefPolicy(policy))
    cfg = get_config(arch, policy=MatmulPolicy(policy))
    if small:
        ref_cfg, cfg = ref_reduced(ref_cfg), reduced(cfg)
    return ref_cfg, cfg


@pytest.mark.parametrize("small", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
def test_measured_explore_equals_reference_under_the_same_walls(
        monkeypatch, arch, policy, small):
    """The port's measured explorer on "cuda" == the reference's on "tpu"
    (its compiled branch, tiles not tuned), both fed the same walls: the
    same candidates, winners, fusions (``none`` where the unfused call
    won), sources, scores and bounds, layer by layer."""
    ref_cfg, cfg = _pair(arch, policy, small)
    monkeypatch.setattr(planner, "_measure_paths", _walls)
    monkeypatch.setattr(ref_planner, "_measure_paths", _walls)
    for requant in (False, True):
        got = planner.explore(cfg, backend="cuda", tune_tiles=False,
                              requant=requant)
        want = ref_planner.explore(ref_cfg, backend="tpu", tune_tiles=False,
                                   requant=requant)
        assert [tuple(getattr(e, f) for f in _COMPARED)
                for e in got.entries] == \
            [tuple(getattr(e, f) for f in _COMPARED) for e in want.entries]
        assert {e.source for e in got.entries} == {"measured"}
        for e in got.entries:   # roofline_us is rounded to the ns
            assert e.roofline_frac == pytest.approx(
                e.roofline_us / e.est_us, rel=0.1, abs=1e-6)
    if not small:
        paths = {e.path for e in got.entries}
        assert "systolic" in {p for g in cnn.cnn_conv_geometries(cfg)
                              for p in planner.candidate_paths(
                                  backend="cuda", policy=cfg.policy,
                                  **{k: g[k] for k in ("kh", "kw", "stride",
                                                       "cin", "cout",
                                                       "padding")})}
        assert paths <= {"im2col", "implicit", "systolic", "winograd"}


def test_candidates_on_the_card_and_on_the_cpu():
    geo = dict(kh=3, kw=3, stride=1, cin=256, cout=512, padding="SAME")
    assert planner.candidate_paths(policy="kom_int14", backend="cuda",
                                   **geo) == ["im2col", "implicit",
                                              "systolic", "winograd"]
    assert planner.candidate_paths(policy="kom_int14", backend="cpu",
                                   **geo) == ["im2col", "implicit",
                                              "winograd"]
    assert planner.candidate_paths(policy="bf16x3", backend="cuda",
                                   **geo) == ["im2col", "implicit"]
    assert planner.candidate_paths(policy="fp32", backend="cuda",
                                   **geo) == ["im2col", "implicit",
                                              "systolic"]
    assert planner.candidate_paths(policy="fp32", backend="cpu",
                                   **geo) == ["im2col"]
    stem = dict(geo, cin=3, cout=64)
    assert planner.candidate_paths(policy="kom_int14", backend="cuda",
                                   **stem) == ["im2col"]


def test_no_candidate_scored_falls_back_to_the_heuristic(monkeypatch,
                                                         capsys):
    cfg = get_config("alexnet", policy=MatmulPolicy.KOM_INT14)
    monkeypatch.setattr(planner, "_measure_paths", lambda paths, **kw: {})
    plan = planner.explore(cfg, tune_tiles=False)
    heur = planner.heuristic_plan(cfg)
    assert [e.path for e in plan.entries] == [e.path for e in heur.entries]
    assert {e.source for e in plan.entries} == {"default"}
    assert all(e.est_us is None and e.roofline_frac is None
               for e in plan.entries)
    out = capsys.readouterr().out
    assert out.count("no candidate scored") == len(plan.entries)


def test_measurement_prunes_only_a_wrapper_refusal(monkeypatch):
    """A wrapper's refusal (ValueError) prunes the candidate; any other
    error (a failed build, a CUDA error) fails the exploration."""
    calls = []

    def timer(fn, *args, **kw):
        path = fn.keywords["path"] if hasattr(fn, "keywords") else "?"
        calls.append(path)
        if path == "winograd":
            raise ValueError("refused")
        return 5.0
    monkeypatch.setattr(tuning, "_time_call", timer)
    geo = dict(kh=3, kw=3, stride=1, h=6, cin=16, cout=16, padding="SAME")
    walls = planner._measure_paths(["im2col", "winograd"], policy="kom_int14",
                                   iters=1, verbose=False, device="cpu",
                                   **geo)
    assert set(walls) == {"im2col"}

    def broken(fn, *args, **kw):
        raise RuntimeError("implicit_conv: CUDA launch failed")
    monkeypatch.setattr(tuning, "_time_call", broken)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        planner._measure_paths(["implicit"], policy="kom_int14", iters=1,
                               verbose=False, device="cpu", **geo)


# -- the tile tuner ----------------------------------------------------------

def test_tune_layer_measures_and_persists(monkeypatch, tmp_path):
    seen = []

    def timer(fn, *args, **kw):
        bk = fn.keywords["block"][2]
        seen.append(bk)
        return 100.0 + abs(bk - 256)
    monkeypatch.setattr(tuning, "_time_call", timer)
    geo = dict(kh=3, kw=3, stride=1, h=4, cin=512, cout=32,
               variant="karatsuba", base_bits=7)
    cache = tuning.TuneCache(tmp_path / "t.json")
    best = tuning.tune_layer("implicit", cache=cache, device="cpu", **geo)
    assert best == (*tuning.IMPLICIT_TILE, 256)
    assert sorted(seen) == [128, 256, 512]
    cache.save()
    back = tuning.TuneCache.load(tmp_path / "t.json")
    ent = back.get(tuning.layer_key("implicit", backend="cpu", **geo))
    assert ent == {"block": [*tuning.IMPLICIT_TILE, 256], "us": 100.0,
                   "measured": True}
    # Nothing to sweep on the systolic and Winograd engines: the tile the
    # kernel runs, untimed and not persisted.
    seen.clear()
    assert tuning.tune_layer("winograd", cache=cache, device="cpu",
                             **geo) == (16, 128)
    assert tuning.tune_layer("systolic", cache=cache, device="cpu",
                             **dict(geo, cout=512)) == (64, 128)
    assert seen == [] and len(cache.entries) == 1


def test_candidate_blocks_sweep_bk_within_cin_and_the_cap():
    geo = dict(kh=3, kw=3, stride=1, h=14, variant="karatsuba", base_bits=7)
    bks = [b[2] for b in tuning.candidate_blocks("implicit", cin=512,
                                                 cout=512, **geo)]
    assert bks == [128, 256, 512]
    assert [b[2] for b in tuning.candidate_blocks(
        "implicit", cin=96, cout=64, **geo)] == [96]
    from repro_torch.kernels.conv2d.implicit_gemm import max_cin_block
    cap = max_cin_block(3, 3, variant="schoolbook", base_bits=8)
    deep = [b[2] for b in tuning.candidate_blocks(
        "implicit", cin=16384, cout=64, **dict(geo, variant="schoolbook",
                                                base_bits=8))]
    assert cap < 16384
    assert deep == [128, 256, 512, 1024, 2048, cap]


def test_resolve_block_hits_the_cache_and_rejects_infeasible(monkeypatch,
                                                              tmp_path):
    from repro_torch.kernels.conv2d.implicit_gemm import max_cin_block

    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path))
    geo = dict(kh=3, kw=3, stride=1, h=28, cin=16384, cout=512,
               variant="schoolbook", base_bits=8)
    cap = max_cin_block(3, 3, variant="schoolbook", base_bits=8)
    default = tuning.default_block("implicit", **geo)
    assert default[2] == cap
    assert tuning.resolve_block("implicit", backend="cuda", **geo) == default
    cache = tuning.TuneCache(tmp_path / tuning.DEFAULT_CACHE_NAME)
    cache.put(tuning.layer_key("implicit", backend="cuda", **geo),
              (64, 64, 256), us=1.0)
    cache.save()
    assert tuning.resolve_block("implicit", backend="cuda", **geo) == \
        (64, 64, 256)
    # backend-scoped: a cuda entry never changes a CPU run
    assert tuning.resolve_block("implicit", backend="cpu", **geo) == default
    # a local overlay wins over the committed default ...
    local = tuning.TuneCache(tmp_path / "measured.local.json")
    local.put(tuning.layer_key("implicit", backend="cuda", **geo),
              (64, 64, 512), us=0.5)
    local.save()
    assert tuning.resolve_block("implicit", backend="cuda", **geo) == \
        (64, 64, 512)
    # ... and an infeasible winner (one K step past the wrap-free cap) is
    # refused for the default
    local.put(tuning.layer_key("implicit", backend="cuda", **geo),
              (64, 64, cap + 8), us=0.1)
    local.save()
    assert not tuning.feasible("implicit", block=(64, 64, cap + 8), **geo)[0]
    assert tuning.resolve_block("implicit", backend="cuda", **geo) == default


def test_feasible_checks_the_port_kernels():
    geo = dict(kh=3, kw=3, stride=1, h=28, cin=256, cout=512,
               variant="karatsuba", base_bits=7)
    assert tuning.feasible("implicit", block=(64, 64, 256), **geo) == \
        (True, "")
    assert tuning.feasible("implicit", block=(64, 64, 256), fusion="pool",
                           **geo)[0]
    assert not tuning.feasible("systolic", block=(64, 128), fusion="pool",
                               **geo)[0]
    assert tuning.feasible("systolic", block=(64, 128), **geo)[0]
    assert not tuning.feasible("systolic", block=(8, 128), **geo)[0]
    assert tuning.feasible("winograd", block=(16, 128), **geo)[0]
    assert not tuning.feasible("winograd", block=(16, 128),
                               **dict(geo, kh=5, kw=5))[0]
    assert not tuning.feasible("winograd", block=(16, 128),
                               **dict(geo, variant="native"))[0]
    assert not tuning.feasible("implicit", block=(64, 64, 0), **geo)[0]
    assert tuning.check() == []


def test_stem_cin_schema(monkeypatch, tmp_path):
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path))
    assert tuning.stem_cin("cuda") == tuning.DEFAULT_STEM_CIN == 16
    geo = dict(kh=3, kw=3, stride=1, cin=16, cout=64,
               policy="kom_int14", cached_weight=True)
    assert planner.heuristic_path(backend="cuda", **geo) == "winograd"
    cache = tuning.TuneCache(tmp_path / tuning.DEFAULT_CACHE_NAME)
    cache.put_stem(32, backend="cuda")
    cache.save()
    assert cache.entries == {"dispatch|stem_cin|cuda": {"cin": 32}}
    assert tuning.stem_cin("cuda") == 32 and tuning.stem_cin("cpu") == 16
    assert planner.heuristic_path(backend="cuda", **geo) == "im2col"
    assert planner.heuristic_path(backend="cpu", **geo) == "winograd"
    for bad in ({"cin": "32"}, {"cin": 0}, {"cin": True}, {"c": 8}, 7):
        cache.entries[tuning.stem_key("cuda")] = bad
        cache.save()
        assert tuning.stem_cin("cuda") == 16


# -- plan artifacts ----------------------------------------------------------

def test_committed_cuda_artifact_passes_check():
    path = planner.plan_path("cuda")
    assert path.parts[-4:] == ("repro_torch", "tuned", "plans", "cuda.json")
    assert planner.check([path]) == []
    plans = planner.load_plans(path, backend="cuda")
    want = {planner.plan_key(m, p) for m in ("alexnet", "vgg16", "vgg19")
            for p in POLICIES}
    assert set(plans) == want
    for plan in plans.values():
        assert {e.source for e in plan.entries} == {"measured"}
        cfg = get_config(plan.model, policy=MatmulPolicy(plan.policy))
        assert planner.resolve_plan(cfg, backend="cuda") == plan
        # a CPU run never sees the card's plan
        assert planner.resolve_plan(cfg, backend="cpu") == \
            planner.heuristic_plan(cfg, backend="cpu")
    assert planner.main(["--check"]) == 0


def test_check_flags_violations(tmp_path):
    full = get_config("vgg16", policy=MatmulPolicy.KOM_INT14)
    plan = planner.explore(full, model_only=True, requant=True)
    p = tmp_path / "cuda.json"

    def write(tampered):
        p.write_text(json.dumps({"schema": planner.PLAN_SCHEMA,
                                 "backend": "cuda",
                                 "plans": {"vgg16|kom_int14":
                                           tampered.to_json()}}))
        return planner.check([p])

    def swap(i, **kw):
        es = list(plan.entries)
        es[i] = dataclasses.replace(es[i], **kw)
        return dataclasses.replace(plan, entries=tuple(es))

    assert write(plan) == []
    gappy = dataclasses.replace(plan, entries=plan.entries[1:])
    assert any("NO entry" in e for e in write(gappy))
    assert any("bad source" in e for e in write(swap(0, source="vibes")))
    extra = dataclasses.replace(plan, entries=plan.entries + (
        dataclasses.replace(plan.entries[0], key=planner.geometry_key(
            kh=9, kw=9, stride=1, h=5, cin=8, cout=8, padding="SAME")),))
    assert any("matches no conv layer" in e for e in write(extra))
    pooled = [i for i, e in enumerate(plan.entries) if e.fusion == "pool"]
    plain = [i for i, e in enumerate(plan.entries)
             if e.fusion == "bias_relu" and e.path == "implicit"]
    assert any("not implementable" in e
               for e in write(swap(pooled[0], path="systolic",
                                   block=(64, 128))))
    assert any("no maxpool follows" in e
               for e in write(swap(plain[0], fusion="pool")))
    assert any("no eligible 3x3/s1" in e
               for e in write(swap(pooled[-1], fusion="pool_quant")))
    assert any("unknown fusion" in e for e in write(swap(0, fusion="fma")))
    assert any("cannot run policy" in e
               for e in write(dataclasses.replace(
                   plan, policy="native_bf16")))
    assert any("block" in e and "bk=0" in e
               for e in write(swap(plain[0], block=(64, 64, 0))))
    assert any("systolic kernel runs tile" in e
               for e in write(swap(plain[0], path="systolic",
                                   block=(8, 128))))
    q = tmp_path / "cpu.json"
    q.write_text(p.read_text())
    assert any("backend" in e for e in planner.check([q]))


# -- traffic model and roofline annotation -----------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_model_traffic_fusion_sequence_matches_reference(fused):
    cfg = get_config("vgg16", policy=MatmulPolicy.KOM_INT14)
    plan = planner.explore(cfg, model_only=True, requant=True)
    ref_plan = ref_planner.ExecutionPlan.from_json(
        json.loads(json.dumps(plan.to_json())), backend="cpu")
    ref_cfg = ref_get_config("vgg16").replace(policy=RefPolicy.KOM_INT14)
    want = ref_traffic.model_traffic(ref_cfg, ref_plan, fused=fused)
    got = traffic.model_traffic(cfg, plan, fused=fused)
    fields = ("key", "path", "fusion", "handoff_in", "pool_after")
    assert [tuple(r[f] for f in fields) for r in got["layers"]] == \
        [tuple(r[f] for f in fields) for r in want["layers"]]
    assert [bool(r["pool_bytes"]) for r in got["layers"]] == \
        [bool(r["pool_bytes"]) for r in want["layers"]]
    assert [bool(r["quant_bytes"]) for r in got["layers"]] == \
        [bool(r["quant_bytes"]) for r in want["layers"]]
    assert got["total_bytes"] == sum(r["total_bytes"] for r in got["layers"])


@pytest.mark.parametrize("arch", ["alexnet", "vgg16", "vgg19"])
def test_fused_traffic_never_exceeds_unfused_per_layer(arch):
    cfg = get_config(arch, policy=MatmulPolicy.SCHOOLBOOK_INT16)
    plan = planner.explore(cfg, model_only=True, requant=True)
    f = traffic.model_traffic(cfg, plan, fused=True)
    u = traffic.model_traffic(cfg, plan, fused=False)
    for a, b in zip(f["layers"], u["layers"]):
        assert a["total_bytes"] <= b["total_bytes"], a["key"]
    rep = traffic.fusion_traffic_report(cfg, plan)
    assert rep["fused_bytes"] == f["total_bytes"]
    if arch != "alexnet":
        assert rep["reduction"] > 0 and rep["pooled_reduction"] > 0


def test_annotate_plan_fields():
    cfg = get_config("alexnet", policy=MatmulPolicy.KOM_INT14)
    plan = planner.heuristic_plan(cfg)
    measured = dataclasses.replace(plan, entries=tuple(
        dataclasses.replace(e, est_us=100.0, source="measured")
        for e in plan.entries))
    out = annotate_plan(measured)
    for e in out.entries:
        g = planner.parse_geometry_key(e.key)
        want = 1e6 * conv_layer_roofline(
            e.path, variant="karatsuba",
            **{k: g[k] for k in ("kh", "kw", "stride", "h", "cin",
                                 "cout")})["roofline_s"]
        assert e.roofline_us == round(want, 3)
        assert e.roofline_frac == round(want / 100.0, 6)
    assert all(e.roofline_frac is None and e.roofline_us > 0
               for e in annotate_plan(plan).entries)
    assert planner.parse_geometry_key(plan.entries[0].key)["padding"] == \
        "VALID"
    with pytest.raises(ValueError):
        planner.parse_geometry_key("k3x3|s1")


# -- the engine's quantization ----------------------------------------------

def test_engine_prequantize_false_quantizes_inside_each_forward(
        monkeypatch):
    """``prequantize=False`` keeps the float weights: each forward runs
    the integer policy's per-tensor ``kom_q_dot`` on them, as the
    reference's engine does.

    Not bitwise: the port's operands take the eager scale rule
    ``max(amax, 1e-12) / qmax`` (ROADMAP.md Queue 3: no rule reproduces the
    jitted ``_kom_q_dot`` on every shape), which moves a few values by one
    14-bit level, so against the jitted reference engine the logits hold
    within 1e-3 of max |logit|.  With the jitted rule ``amax *
    f32(1/qmax)`` in its place the same engine lands within 1e-6, a limit
    that the unquantized fp32 forward and the per-channel prequantized
    engine both miss: the forward quantizes per tensor, per call, as the
    reference does.  The two rules also differ on a weight of this very
    model."""
    ref_cfg = ref_reduced(ref_get_config("alexnet")).replace(
        policy=RefPolicy.KOM_INT14)
    cfg = reduced(get_config("alexnet", policy=MatmulPolicy.KOM_INT14))
    # Seeded numpy weights in the models' layout (the reference's own
    # init takes seconds of eager JAX), non-zero biases.
    rng = np.random.default_rng(0)
    params = [{k: (rng.standard_normal(tuple(v.shape))
                   * (0.1 if k == "b" else 1 / np.sqrt(np.prod(
                       v.shape[:-1])))).astype(np.float32)
               for k, v in p.items()}
              for p in cnn.cnn_init(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")]
    x = rng.standard_normal((2, cfg.img_size, cfg.img_size, 3)).astype(
        np.float32)
    tp = params_from_numpy(params, device="cpu")
    eng = CNNServeEngine(cfg, tp, buckets=(2,), device="cpu",
                         prequantize=False)
    assert not any(isinstance(p.get("w"), substrate.QWeight)
                   for p in eng.params)
    got = eng.run_batch(x)
    with torch.inference_mode():
        again = cnn.cnn_forward(tp, cfg, torch.from_numpy(x)).numpy()
        fp32 = cnn.cnn_forward(tp, dataclasses.replace(
            cfg, policy=MatmulPolicy.FP32), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, again)
    cached = CNNServeEngine(cfg, tp, buckets=(2,), device="cpu")
    assert all(isinstance(p["w"], substrate.QWeight)
               for p in cached.params if "w" in p)
    cached_out = cached.run_batch(x)
    ref = RefEngine(ref_cfg, params, buckets=(2,), prequantize=False)
    want = np.asarray(ref._forward(ref.params, x))

    def gap(out):
        return float(np.abs(out - want).max() / np.abs(want).max())

    # The eager rule: 1.9e-4 for this seed, 0 to 3.35e-4 over 8 seeds.
    assert gap(got) <= 1e-3
    from repro_torch.core import precision
    qmax = substrate.kom_qmax(7)
    amaxes = [p["w"].abs().amax() for p in tp if "w" in p]
    assert any(precision.operand_scale(a, qmax)
               != substrate.activation_scale(a, qmax) for a in amaxes)
    monkeypatch.setattr(precision, "operand_scale",
                        substrate.activation_scale)
    jit_rule = eng.run_batch(x)
    # The jitted rule: 2.4e-7 for this seed; fp32 1.5e-4, cached 2.7e-4.
    assert gap(jit_rule) <= 1e-6
    assert gap(fp32) > 1e-6 and gap(cached_out) > 1e-6


def test_engine_tune_writes_the_local_cache(monkeypatch, tmp_path):
    """``tune=True`` sweeps the config's implicit layers on the engine's
    device into ``measured.local.json``, which the dispatch then reads."""
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(tuning, "_time_call",
                        lambda fn, *a, **k: 1.0 / fn.keywords["block"][2])
    cfg = reduced(get_config("vgg16", policy=MatmulPolicy.KOM_INT14))
    params = cnn.cnn_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    CNNServeEngine(cfg, params, buckets=(1,), device="cpu", tune=True)
    cache = tuning.TuneCache.load(tmp_path / tuning.LOCAL_CACHE_NAME)
    assert not (tmp_path / tuning.DEFAULT_CACHE_NAME).exists()
    shapes = tuning.conv_layer_shapes(cfg)
    keys = {tuning.layer_key("implicit", variant="karatsuba", base_bits=7,
                             backend="cpu", **s) for s in shapes}
    assert set(cache.entries) == keys
    for s in shapes:
        assert tuning.resolve_block("implicit", variant="karatsuba",
                                    base_bits=7, backend="cpu", **s) == \
            (*tuning.IMPLICIT_TILE, s["cin"])


def test_launcher_explores_by_measurement(capsys, monkeypatch):
    """``--explore`` without ``--model-only`` times the engines on the
    device it serves on (the CPU here, reduced widths; a patched timer)."""
    from repro_torch.launch.serve import main

    monkeypatch.setattr(tuning, "_time_call", lambda fn, *a, **k: 3.0)

    assert main(["--arch", "alexnet", "--reduced", "--device", "cpu",
                 "--requests", "2", "--buckets", "1,2", "--policy",
                 "kom_int14", "--explore", "--requant"]) == 0
    out = capsys.readouterr().out
    assert "(measured)" in out and "(model)" not in out
    assert "2 images" in out


def test_launcher_tune_sweeps_into_the_local_cache(capsys, monkeypatch,
                                                  tmp_path):
    """``--tune`` runs the engine's tile sweep on the serving device before
    it serves: one ``measured.local.json`` entry per conv layer."""
    from repro_torch.launch.serve import main

    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(tuning, "_time_call", lambda fn, *a, **k: 2.0)
    assert main(["--arch", "alexnet", "--reduced", "--device", "cpu",
                 "--requests", "1", "--buckets", "1", "--policy",
                 "kom_int14", "--tune"]) == 0
    assert "1 images" in capsys.readouterr().out
    cfg = reduced(get_config("alexnet", policy=MatmulPolicy.KOM_INT14))
    cache = tuning.TuneCache.load(tmp_path / tuning.LOCAL_CACHE_NAME)
    assert set(cache.entries) == {
        tuning.layer_key("implicit", variant="karatsuba", base_bits=7,
                         backend="cpu", **s)
        for s in tuning.conv_layer_shapes(cfg)}
