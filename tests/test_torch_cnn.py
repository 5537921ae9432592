"""The port's CNN slice end to end: models, planner, engine, launcher.

Reduced AlexNet and VGG16 under both integer policies: the port's logits
equal ``jax.jit(cnn_forward)`` bit for bit, with the reference's params
carried across by ``repro_torch.convert`` (biases made non-zero so the
fused dequant+bias epilogue is exercised) and one explicit heuristic plan
given to both sides.  Then the port's own contracts: engine batch
invariance and the OOM degrade ladder (bitwise), the launcher on the CPU,
and the package's hygiene (no JAX, no JAX package, no silent CPU fallback).
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import planner as ref_planner  # noqa: E402
from repro.core.precision import MatmulPolicy as RefPolicy  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.serving.cnn_engine import (CNNServeEngine,  # noqa: E402
                                            ImageRequest)
from repro_torch.serving.scheduler import RetryPolicy  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "repro_torch"
POLICIES = ["kom_int14", "schoolbook_int16"]


def _configs(arch, policy):
    ref_cfg = ref_reduced(ref_get_config(arch)).replace(
        policy=RefPolicy(policy))
    cfg = reduced(get_config(arch)).replace(policy=MatmulPolicy(policy))
    return ref_cfg, cfg


def _ref_params(ref_cfg, seed):
    """Reference params as numpy, with non-zero biases."""
    params = jax.tree.map(np.asarray,
                          ref_cnn.cnn_init(ref_cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for p in params:
        if "b" in p:
            p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(
                np.float32)
    return params


def _images(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
def test_logits_equal_jitted_reference(arch, policy):
    ref_cfg, cfg = _configs(arch, policy)
    params = _ref_params(ref_cfg, seed=0)
    plan = planner.heuristic_plan(cfg, backend="cpu")
    ref_plan = ref_planner.ExecutionPlan.from_json(plan.to_json(),
                                                   backend="cpu")
    paths = [e.path for e in plan.entries]
    assert paths[0] == "im2col" and "winograd" in paths
    assert ("implicit" in paths) == (arch == "alexnet")
    x = _images(cfg, 3, seed=1)
    qp_ref = ref_cnn.cnn_quantize_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params], ref_cfg)
    fwd = jax.jit(lambda p, v: ref_cnn.cnn_forward(p, ref_cfg, v,
                                                   plan=ref_plan))
    want = np.asarray(fwd(qp_ref, jnp.asarray(x)))
    qp = cnn.cnn_quantize_params(params_from_numpy(params, device="cpu"),
                                 cfg)
    got = cnn.cnn_forward(qp, cfg, torch.from_numpy(x), plan=plan).numpy()
    assert got.shape == (3, cfg.n_classes)
    np.testing.assert_array_equal(got, want)


def test_plans_match_reference_schema_and_rules():
    """Same execution-plan/v1 JSON as the reference's rule (stem 16), for
    every CNN at both sizes, and the same degraded-mode plan."""
    for arch in ("alexnet", "vgg16", "vgg19"):
        for policy in POLICIES + ["fp32"]:
            for size in (lambda c: c, reduced):
                cfg = size(get_config(arch)).replace(
                    policy=MatmulPolicy(policy))
                plan = planner.heuristic_plan(cfg, backend="cpu")
                for g in cnn.cnn_conv_geometries(cfg):
                    e = plan.by_key[ref_planner.geometry_key(**g)]
                    assert e.path == ref_planner.heuristic_path(
                        on_tpu=False, policy=policy,
                        cached_weight=policy != "fp32", stem_cin=16,
                        **{k: v for k, v in g.items() if k != "h"})
                ref_plan = ref_planner.ExecutionPlan.from_json(
                    plan.to_json(), backend="cpu")
                assert ref_plan.to_json() == plan.to_json()
                assert ref_planner.materialized_fallback_plan(
                    ref_plan).to_json() == \
                    planner.materialized_fallback_plan(plan).to_json()
    full = get_config("alexnet", policy=MatmulPolicy.KOM_INT14)
    assert [e.path for e in planner.heuristic_plan(full).entries] == \
        ["im2col", "implicit", "winograd", "winograd", "winograd"]
    assert cnn.cnn_layer_topology(full) == ref_cnn.cnn_layer_topology(
        ref_get_config("alexnet"))
    with pytest.raises(planner.PlanArtifactError):
        planner.resolve_plan(full, planner.heuristic_plan(full,
                                                          backend="cpu"))


def _engine(cfg, params, **kw):
    return CNNServeEngine(cfg, params, device="cpu", **kw)


def test_engine_batch_invariance_bitwise():
    """Padded-microbatch logits == single-image forward, bitwise."""
    _, cfg = _configs("alexnet", "kom_int14")
    params = cnn.cnn_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    eng = _engine(cfg, params, buckets=(4,))
    imgs = _images(cfg, 3, seed=2)
    for uid, img in enumerate(imgs):
        eng.submit(ImageRequest(uid=uid, image=img))
    done = eng.run()
    assert sorted(done) == [0, 1, 2]
    assert eng.batcher.padded_rows == 1
    for uid, img in enumerate(imgs):
        solo = eng.forward(torch.from_numpy(img[None])).numpy()[0]
        np.testing.assert_array_equal(done[uid].logits, solo)
    s = eng.stats()
    assert s["images_done"] == 3 and s["health"] == "healthy"


def test_engine_oom_degrade_keeps_logits_bitwise():
    """OOM-shaped failures walk the ladder: drop the largest bucket, then
    reroute to the materialized im2col plan -- same logits."""
    _, cfg = _configs("alexnet", "schoolbook_int16")
    gen = torch.Generator().manual_seed(1)
    params = cnn.cnn_init(cfg, gen, device="cpu")
    for p in params:
        if "b" in p:  # non-zero biases: the fused epilogue must agree too
            p["b"] = 0.1 * torch.randn(p["b"].shape, generator=gen)
    imgs = _images(cfg, 2, seed=3)
    healthy = _engine(cfg, params, buckets=(2,))
    want = healthy.forward(torch.from_numpy(imgs)).numpy()
    eng = _engine(cfg, params, buckets=(1, 2),
                  retry=RetryPolicy(max_attempts=4))
    real_forward, fails = eng.forward, [2]

    def flaky(x):
        if fails[0]:
            fails[0] -= 1
            raise RuntimeError("CUDA out of memory (injected)")
        return real_forward(x)

    eng.forward = flaky
    for uid, img in enumerate(imgs):
        eng.submit(ImageRequest(uid=uid, image=img))
    done = eng.run()
    assert eng.degrade_log == ["dropped bucket 2",
                               "rerouted plan to materialized im2col"]
    assert {e.path for e in eng.plan.entries} == {"im2col"}
    for uid in range(2):
        np.testing.assert_array_equal(done[uid].logits, want[uid])


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch.serve import main
    rc = main(["--arch", "vgg16", "--reduced", "--device", "cpu",
               "--requests", "3", "--buckets", "1,2", "--policy",
               "kom_int14"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "3 images" in out and "on cpu" in out


def test_entry_points_refuse_to_fall_back_to_cpu():
    """Without an explicit CPU request the entry points run on the GPU --
    and without one they raise instead of continuing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = reduced(get_config("alexnet"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn.cnn_init(cfg, torch.Generator().manual_seed(0))
    params = cnn.cnn_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CNNServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy([{"w": np.zeros((2, 2), np.float32)}])
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "alexnet", "--reduced", "--requests", "1"])


def test_port_sources_never_import_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                     r"from repro\b|import repro\.|from repro\.)", re.M)
    for p in files:
        assert not bad.search(p.read_text()), p


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.models,"
            " repro_torch.kernels.kom_matmul, repro_torch.kernels.conv2d,"
            " repro_torch.serving.cnn_engine, repro_torch.launch.serve,"
            " repro_torch.convert, chip_smoke;"
            " bad = [m for m in sys.modules if m == 'jax' or m == 'repro'"
            " or m.startswith(('jax.', 'repro.'))];"
            " assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_chip_smoke_refuses_without_a_gpu_or_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout


def test_scheduler_copy_matches_reference():
    """The port's scheduler is a copy (the port never imports the JAX
    package): everything below the module docstring is identical."""
    def body(p):
        text = p.read_text()
        return text[text.index('"""', 3) + 3:]
    assert body(PORT / "serving" / "scheduler.py") == \
        body(REPO / "src" / "repro" / "serving" / "scheduler.py")
