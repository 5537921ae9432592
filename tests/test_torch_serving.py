"""The port's serving under faults: injector, dispatcher, SLOs, both engines.

Twins of the reference's ``test_faults.py``, ``test_dispatcher.py``,
``test_resilience.py`` and ``test_slo_serving.py`` on the port's modules,
with the port's engines on reduced configs on the CPU (the plain versions
of the kernels):

* the fault substrate and the dispatcher are copies of the reference's
  numpy-only modules, checked line for line;
* chaos conserves requests (``done + expired + failed == submitted``) and
  retried logits or greedy tokens equal a fault-free port run bit for bit;
* one fault plan, retry policy and fake clock through the reference's
  ``CNNServeEngine`` and the port's, each with a stubbed numpy forward,
  give the same ledger;
* the OOM degrade ladder on a plan with a systolic layer serves the
  fallback plan's own forward, not the healthy logits;
* serving code waits only on the injected clock (grep contract), and the
  launcher validates its resilience flags at parse time.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.precision import MatmulPolicy as RefPolicy  # noqa: E402
from repro.serving.cnn_engine import CNNServeEngine as RefEngine  # noqa: E402
from repro.serving.cnn_engine import ImageRequest as RefImage  # noqa: E402
from repro.serving.faults import FaultPlan as RefFaultPlan  # noqa: E402
from repro.serving.scheduler import RetryPolicy as RefRetry  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.precision import MatmulPolicy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.clock import ManualClock  # noqa: E402
from repro_torch.serving.cnn_engine import (CNNServeEngine,  # noqa: E402
                                            ImageRequest)
from repro_torch.serving.dispatcher import MultiModelDispatcher  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serving.faults import (FaultInjector, FaultPlan,  # noqa: E402
                                        OOMFault, PoisonFault,
                                        TransientFault)
from repro_torch.serving.scheduler import (BatchContractError,  # noqa: E402
                                           EngineDownError, Expired, Failed,
                                           IncompleteRunError, RequestQueue,
                                           RetryPolicy, classify_failure)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "repro_torch"
REF = REPO / "src" / "repro"


@dataclasses.dataclass
class Req:
    uid: int


def _conserved(q) -> bool:
    return (len(q.done) + len(q.expired) + len(q.failed)
            == q.submitted_count)


# -- the copies ---------------------------------------------------------------

def _body(path: pathlib.Path) -> str:
    text = path.read_text()
    return text[text.index('"""', 3) + 3:]


def test_faults_copy_matches_reference():
    """The port's fault injector is a copy (the port never imports the JAX
    package): everything below the module docstring is identical."""
    assert _body(PORT / "serving" / "faults.py") == \
        _body(REF / "serving" / "faults.py")


def test_dispatcher_copy_matches_reference_but_its_import():
    ref = (REF / "serving" / "dispatcher.py").read_text().splitlines()
    port = (PORT / "serving" / "dispatcher.py").read_text().splitlines()
    diff = [(a, b) for a, b in zip(ref, port) if a != b]
    assert len(ref) == len(port)
    assert diff == [(
        "from repro.serving.scheduler import IncompleteRunError, "
        "classify_failure",
        "from repro_torch.serving.scheduler import IncompleteRunError, "
        "classify_failure")]


# -- FaultPlan declaration + parsing (twins of test_faults.py) ----------------

def test_fault_plan_validates_rates():
    with pytest.raises(ValueError, match="transient_rate"):
        FaultPlan(transient_rate=1.5)
    with pytest.raises(ValueError, match="poison_rate"):
        FaultPlan(poison_rate=-0.1)
    with pytest.raises(ValueError, match="transient_fails"):
        FaultPlan(transient_fails=0)
    with pytest.raises(ValueError, match="latency_s"):
        FaultPlan(latency_s=-1.0)


def test_fault_plan_parse_spec():
    p = FaultPlan.parse("transient=0.1,poison=0.02,oom=0.05,latency=0.2",
                        seed=7)
    assert p.seed == 7
    assert p.transient_rate == pytest.approx(0.1)
    assert p.poison_rate == pytest.approx(0.02)
    assert p.oom_rate == pytest.approx(0.05)
    assert p.latency_rate == pytest.approx(0.2)
    p2 = FaultPlan.parse("transient_fails=3,latency_s=0.5")
    assert p2.transient_fails == 3 and p2.latency_s == 0.5
    assert FaultPlan.parse("") == FaultPlan()


def test_fault_plan_parse_rejects_garbage():
    with pytest.raises(ValueError, match="unknown fault spec key"):
        FaultPlan.parse("bogus=1")
    with pytest.raises(ValueError, match="malformed"):
        FaultPlan.parse("transient")
    with pytest.raises(ValueError, match="bad value"):
        FaultPlan.parse("poison=lots")
    with pytest.raises(ValueError, match="oom_rate"):
        FaultPlan.parse("oom=2.0")


def test_fault_decisions_are_schedule_independent():
    plan = FaultPlan(seed=3, transient_rate=0.3, poison_rate=0.2)
    a, b = FaultInjector(plan), FaultInjector(plan)
    uids = list(range(50))
    fwd = [(a.is_poison(u), a.is_transient(u)) for u in uids]
    rev = [(b.is_poison(u), b.is_transient(u)) for u in reversed(uids)]
    assert fwd == list(reversed(rev))
    assert any(p for p, _ in fwd) and not all(p for p, _ in fwd)


def test_fault_decisions_depend_on_seed_and_match_the_reference():
    """Per-uid decisions depend on the seed, and are the reference's own:
    ``(seed, kind, uid)`` through ``zlib.crc32`` and ``SeedSequence``."""
    from repro.serving.faults import FaultInjector as RefInjector
    uids = list(range(200))
    one = [FaultInjector(FaultPlan(seed=1, poison_rate=0.3)).is_poison(u)
           for u in uids]
    two = [FaultInjector(FaultPlan(seed=2, poison_rate=0.3)).is_poison(u)
           for u in uids]
    assert one != two
    for seed in (1, 2):
        plan = dict(seed=seed, poison_rate=0.3, transient_rate=0.4)
        port, ref = FaultInjector(FaultPlan(**plan)), \
            RefInjector(RefFaultPlan(**plan))
        assert [(port.is_poison(u), port.is_transient(u)) for u in uids] \
            == [(ref.is_poison(u), ref.is_transient(u)) for u in uids]


def test_forced_poison_uids():
    inj = FaultInjector(FaultPlan(seed=0, poison_uids=(17,)))
    assert inj.is_poison(17)
    with pytest.raises(PoisonFault, match="uid 17"):
        inj.check((1, 17, 3))


def test_wrap_declares_wants_uids_and_injects():
    inj = FaultInjector(FaultPlan(seed=0, poison_uids=(2,)),
                        clock=lambda: 0.0)
    calls = []
    fwd = inj.wrap(lambda batch: calls.append(1) or batch * 2)
    assert getattr(fwd, "wants_uids", False)
    with pytest.raises(PoisonFault):
        fwd(np.ones((2, 1)), uids=(1, 2))
    assert calls == []
    out = fwd(np.ones((2, 1)), uids=(1, 3))
    assert np.array_equal(out, np.full((2, 1), 2.0)) and calls == [1]
    assert inj.stats()["injected"]["poison"] == 1


def test_transient_fault_heals_after_budget():
    inj = FaultInjector(FaultPlan(seed=0, transient_rate=1.0,
                                  transient_fails=2))
    for _ in range(2):
        with pytest.raises(TransientFault):
            inj.check((5,))
    inj.check((5,))
    assert inj.stats()["injected"]["transient"] == 2


def test_oom_fault_is_oom_shaped():
    inj = FaultInjector(FaultPlan(seed=0, oom_rate=1.0))
    with pytest.raises(OOMFault) as ei:
        inj.check(())
    assert classify_failure(ei.value) == "oom"
    assert "RESOURCE_EXHAUSTED" in str(ei.value)


def test_latency_spike_skews_the_wrapped_clock():
    t = [100.0]
    inj = FaultInjector(FaultPlan(seed=0, latency_rate=1.0, latency_s=0.5),
                        clock=lambda: t[0])
    assert inj.now() == pytest.approx(100.0)
    fwd = inj.wrap(lambda b: b)
    fwd(np.zeros((1, 1)), uids=(0,))
    assert inj.now() == pytest.approx(100.5)
    fwd(np.zeros((1, 1)), uids=(0,))
    assert inj.now() == pytest.approx(101.0)
    assert inj.stats()["clock_skew_s"] == pytest.approx(1.0)


def test_classify_failure_taxonomy():
    """The reference's taxonomy, plus the card's own OOM: PyTorch raises
    ``torch.OutOfMemoryError`` ("CUDA out of memory") where XLA raises
    RESOURCE_EXHAUSTED, and the engines must degrade on it."""
    assert classify_failure(KeyboardInterrupt()) == "fatal"
    assert classify_failure(SystemExit()) == "fatal"
    assert classify_failure(BatchContractError("rows exceed bucket")) == \
        "fatal"
    assert classify_failure(MemoryError()) == "oom"
    assert classify_failure(RuntimeError("RESOURCE_EXHAUSTED: boo")) == "oom"
    assert classify_failure(RuntimeError("device ran out of memory")) == \
        "oom"
    assert classify_failure(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "oom"
    assert classify_failure(RuntimeError("socket reset")) == "transient"
    assert classify_failure(ValueError("weird shape")) == "transient"


def test_retry_policy_backoff_and_validation():
    p = RetryPolicy(max_attempts=4, backoff_base=0.01, backoff_mult=2.0,
                    backoff_cap=0.05)
    assert [p.backoff(n) for n in (1, 2, 3, 4, 10)] == \
        pytest.approx([0.01, 0.02, 0.04, 0.05, 0.05])
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="bisect_after"):
        RetryPolicy(bisect_after=0)


# -- the dispatcher over stub engines (twins of test_dispatcher.py and the
# -- dispatcher cases of test_resilience.py) ----------------------------------

class FakeEngine:
    """One request served per step, EDF, on the real queue; optionally
    explodes."""

    def __init__(self, clock, explode=None):
        self._rq = RequestQueue(clock=clock)
        self.health = "healthy"
        self.explode = explode
        self.served = []

    def submit(self, req, **kw):
        if self.health == "down":
            raise EngineDownError("down")
        self._rq.submit(req, deadline=kw.get("deadline"), slo=kw.get("slo"))

    def has_work(self):
        return bool(len(self._rq))

    def urgency(self):
        return self._rq.urgency()

    def step(self):
        if self.explode:
            raise self.explode
        self._rq.expire_overdue()
        for req in self._rq.take(1, order="edf"):
            self._rq.finish(req)
            self.served.append(req.uid)

    def mark_down(self, reason="down"):
        self.health = "down"
        return self._rq.fail_pending(EngineDownError(reason))

    @property
    def request_queue(self):
        return self._rq


def _disp(clock, names=("cnn", "lm")):
    disp = MultiModelDispatcher()
    for n in names:
        disp.register(n, FakeEngine(clock))
    return disp


def test_register_enforces_protocol_and_unique_names():
    disp = MultiModelDispatcher()
    disp.register("a", FakeEngine(ManualClock()))
    with pytest.raises(ValueError, match="already registered"):
        disp.register("a", FakeEngine(ManualClock()))

    class NotAnEngine:
        def has_work(self):
            return False

    with pytest.raises(TypeError, match="lacks 'urgency'"):
        disp.register("b", NotAnEngine())
    with pytest.raises(KeyError, match="unknown model"):
        disp.submit("zzz", Req(0))


def test_earliest_deadline_model_steps_first():
    clk = ManualClock()
    disp = _disp(clk)
    disp.submit("cnn", Req(0), deadline=10.0)
    disp.submit("lm", Req(1), deadline=2.0)
    assert disp.next_model() == "lm"
    assert disp.step() == "lm"
    assert disp.next_model() == "cnn"
    disp.step()
    assert disp.next_model() is None and disp.step() is None


def test_interactive_request_overtakes_batch_backlog_on_other_model():
    clk = ManualClock()
    disp = _disp(clk)
    for uid in range(3):
        disp.submit("cnn", Req(uid))
    clk.t = 1.0
    disp.submit("lm", Req(9), slo="interactive")
    assert [disp.step() for _ in range(4)] == ["lm", "cnn", "cnn", "cnn"]


def test_deadline_tie_breaks_on_submit_then_registration():
    clk = ManualClock()
    disp = _disp(clk)
    disp.submit("lm", Req(0))
    clk.t = 1.0
    disp.submit("cnn", Req(1))
    assert disp.next_model() == "lm"
    disp2 = _disp(ManualClock())
    disp2.submit("cnn", Req(0))
    disp2.submit("lm", Req(1))
    assert disp2.next_model() == "cnn"


def test_run_drains_every_engine_and_returns_ledgers():
    disp = _disp(ManualClock())
    for uid in range(3):
        disp.submit("cnn", Req(uid))
    disp.submit("lm", Req(7), deadline=50.0)
    done = disp.run()
    assert sorted(done["cnn"]) == [0, 1, 2] and sorted(done["lm"]) == [7]
    s = disp.stats()
    assert s["requests_done"] == 4 and s["requests_expired"] == 0
    assert s["per_model"]["cnn"]["dispatch_steps"] == 3
    assert s["per_model"]["lm"]["dispatch_steps"] == 1


def test_run_truncated_raises_with_model_qualified_uids():
    disp = _disp(ManualClock())
    for uid in range(2):
        disp.submit("cnn", Req(uid))
    disp.submit("lm", Req(5))
    with pytest.raises(IncompleteRunError, match="still pending") as ei:
        disp.run(max_steps=1)
    assert set(ei.value.pending_uids) == {"cnn:1", "lm:5"}
    done = disp.run()
    assert sorted(done["cnn"]) == [0, 1] and sorted(done["lm"]) == [5]


def test_expired_requests_roll_up_in_stats():
    clk = ManualClock()
    disp = _disp(clk)
    disp.submit("cnn", Req(0), deadline=1.0)
    disp.submit("cnn", Req(1))
    clk.t = 2.0
    done = disp.run()
    assert sorted(done["cnn"]) == [1]
    assert list(disp.engine("cnn").request_queue.expired) == [0]
    s = disp.stats()
    assert s["requests_done"] == 1 and s["requests_expired"] == 1


def test_dispatcher_contains_engine_failure_without_stranding_others():
    clk = ManualClock()
    disp = MultiModelDispatcher()
    bad = FakeEngine(clk, explode=RuntimeError("engine exploded"))
    good = FakeEngine(clk)
    disp.register("bad", bad)
    disp.register("good", good)
    for uid in range(3):
        disp.submit("bad", Req(uid))
        disp.submit("good", Req(100 + uid))
    done = disp.run()
    assert sorted(done["good"]) == [100, 101, 102]
    assert bad.health == "down"
    assert sorted(bad.request_queue.failed) == [0, 1, 2]
    s = disp.stats()
    assert s["health"] == {"bad": "down", "good": "healthy"}
    assert "bad" in s["contained"]
    assert (s["requests_done"], s["requests_failed"]) == (3, 3)
    assert s["requests_done"] + s["requests_expired"] \
        + s["requests_failed"] == 6


def test_dispatcher_fatal_errors_still_propagate():
    disp = MultiModelDispatcher()
    disp.register("a", FakeEngine(ManualClock(), explode=KeyboardInterrupt()))
    disp.submit("a", Req(0))
    with pytest.raises(KeyboardInterrupt):
        disp.step()


def test_dispatcher_skips_down_engine_on_submit_and_dispatch():
    clk = ManualClock()
    disp = MultiModelDispatcher()
    a, b = FakeEngine(clk), FakeEngine(clk)
    disp.register("a", a)
    disp.register("b", b)
    disp.submit("a", Req(0))
    disp.submit("b", Req(1))
    a.mark_down()
    assert disp.next_model() == "b"
    disp.run()
    assert b.served == [1]
    assert sorted(a.request_queue.failed) == [0]
    with pytest.raises(EngineDownError):
        disp.submit("a", Req(2))


def test_dispatcher_stranded_uids_stay_model_qualified():
    clk = ManualClock()
    disp = MultiModelDispatcher()
    disp.register("x", FakeEngine(clk))
    disp.register("y", FakeEngine(clk))
    disp.submit("x", Req(7))
    disp.submit("y", Req(7))
    with pytest.raises(IncompleteRunError) as ei:
        disp.run(max_steps=1)
    assert set(ei.value.pending_uids) == {"y:7"}


def test_real_engines_satisfy_the_protocol():
    """Both port engines expose the dispatcher protocol, structurally."""
    for eng_cls in (CNNServeEngine, ServeEngine):
        for attr in ("has_work", "urgency", "step", "request_queue",
                     "submit", "mark_down", "stats"):
            assert hasattr(eng_cls, attr), (eng_cls.__name__, attr)


# -- the CNN engine under chaos (test_resilience.py on the port) -------------

def _cnn_cfg(policy="kom_int14", conv_path="auto"):
    return reduced(get_config("alexnet")).replace(
        policy=MatmulPolicy(policy), conv_path=conv_path)


def _cnn_params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = cnn.cnn_init(cfg, gen, device="cpu")
    for p in params:   # non-zero biases: the epilogues must agree too
        if "b" in p:
            p["b"] = 0.1 * torch.randn(p["b"].shape, generator=gen)
    return params


def _imgs(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(
        (cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)
        for _ in range(n)]


def _serve(eng, imgs, **kw):
    for uid, img in enumerate(imgs):
        eng.submit(ImageRequest(uid=uid, image=img, **kw))
    return eng.run()


@pytest.mark.parametrize("policy", ["kom_int14", "schoolbook_int16"])
def test_cnn_chaos_conserves_and_retried_logits_bitwise(policy):
    cfg = _cnn_cfg(policy, conv_path="im2col")
    params = _cnn_params(cfg)
    imgs = _imgs(cfg, 8)
    ref_done = _serve(CNNServeEngine(cfg, params, buckets=(1, 4),
                                     device="cpu"), imgs)
    clk = ManualClock()
    plan = FaultPlan(seed=1, transient_rate=1.0, transient_fails=1,
                     poison_uids=(3,))
    # innocents in a poisoned batch burn attempts before bisection corners
    # the poison: the budget must outlast the split depth
    eng = CNNServeEngine(cfg, params, buckets=(1, 4), device="cpu",
                         clock=clk, faults=plan, advance=clk.advance_to,
                         retry=RetryPolicy(max_attempts=6,
                                           backoff_base=0.001))
    done = _serve(eng, imgs)
    q = eng.request_queue
    assert _conserved(q)
    assert sorted(done) == [u for u in range(8) if u != 3]
    assert list(q.failed) == [3] and isinstance(q.failed[3], Failed)
    assert q.failed[3].attempts >= 3
    s = eng.stats()
    assert s["retries"] > 0 and s["bisections"] > 0
    # each innocent faults once; the poison check fires first for uid 3
    assert s["faults"]["injected"]["transient"] == 7
    assert s["faults"]["injected"]["poison"] >= 3
    for uid in done:
        assert np.array_equal(done[uid].logits, ref_done[uid].logits), uid
    assert eng.health == "healthy"


@pytest.mark.parametrize("attempts", [6, 7])
def test_chaos_budget_must_outlast_the_bisection_depth(attempts,
                                                       monkeypatch):
    """The card's chaos run (32 requests, buckets 1/4/16, every request
    transient once, uid 3 poisoned): a 16-image batch fails twice, then
    once at 8, 4 and 2 images, and an innocent may meet its own transient
    alone -- 6 failures before it serves.  A budget of 6 quarantines
    innocents; 7 (the budget of the card's chaos phase) fails uid 3
    alone."""
    cfg = _cnn_cfg()
    monkeypatch.setattr(CNNServeEngine, "run_batch",
                        lambda self, b: _stub_logits(b, cfg.n_classes))
    clk = ManualClock()
    eng = CNNServeEngine(cfg, _cnn_params(cfg), buckets=(1, 4, 16),
                         device="cpu", clock=clk, advance=clk.advance_to,
                         faults=FaultPlan(seed=1, transient_rate=1.0,
                                          transient_fails=1,
                                          poison_uids=(3,)),
                         retry=RetryPolicy(max_attempts=attempts,
                                           backoff_base=0.001))
    _serve(eng, _imgs(cfg, 32))
    assert _conserved(eng.request_queue)
    failed = sorted(eng.failed)
    if attempts == 7:
        assert failed == [3]
    else:
        assert 3 in failed and len(failed) > 1


def test_cnn_degraded_mode_stays_bitwise_then_goes_down():
    """The heuristic plan (im2col, implicit, Winograd: one scale plan, no
    systolic, no pool fusion): drop the largest bucket, reroute to the
    materialized fallback -- the healthy logits, bit for bit -- then down
    with everything failed typed."""
    cfg = _cnn_cfg()
    params = _cnn_params(cfg)
    imgs = _imgs(cfg, 4)
    ref_done = _serve(CNNServeEngine(cfg, params, buckets=(1, 4),
                                     device="cpu"), imgs)
    clk = ManualClock()
    eng = CNNServeEngine(cfg, params, buckets=(1, 4), device="cpu",
                         clock=clk, advance=clk.advance_to,
                         retry=RetryPolicy(max_attempts=10,
                                           backoff_base=0.001))
    assert {e.path for e in eng.plan.entries} >= {"implicit", "winograd"}
    oom, real = [2], eng._serve_fn

    def flaky(batch):
        if oom[0]:
            oom[0] -= 1
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(batch)

    eng._serve_fn = flaky
    done = _serve(eng, imgs)
    assert eng.health == "degraded" and eng.buckets == (1,)
    assert eng.degrade_log == ["dropped bucket 4",
                               "rerouted plan to materialized im2col"]
    assert all(e.path == "im2col" for e in eng.plan.entries)
    assert sorted(done) == list(range(4)) and _conserved(eng.request_queue)
    for uid in done:
        assert np.array_equal(done[uid].logits, ref_done[uid].logits), uid
    eng.submit(ImageRequest(uid=100, image=imgs[0]))
    oom[0] = 10
    eng.run()
    assert eng.health == "down"
    assert isinstance(eng.failed[100], Failed)
    assert _conserved(eng.request_queue)
    with pytest.raises(EngineDownError, match="down"):
        eng.submit(ImageRequest(uid=101, image=imgs[0]))


def test_cnn_degrade_on_a_systolic_plan_serves_the_fallback_forward():
    """A plan with a systolic layer (as every committed ``cuda.json`` plan
    has): after the ladder the engine serves ``cnn_forward`` under
    ``materialized_fallback_plan(plan)`` bit for bit -- which is not the
    healthy logits, since the systolic engine quantizes per sample."""
    cfg = _cnn_cfg("schoolbook_int16")
    params = _cnn_params(cfg, seed=4)
    heur = planner.heuristic_plan(cfg, backend="cpu")
    # conv2 on the systolic engine; the stem (im2col) and the 3x3 layers
    # (Winograd) as the heuristic has them
    plan = dataclasses.replace(heur, entries=tuple(
        dataclasses.replace(e, path="systolic", block=None)
        if e.path == "implicit" else e for e in heur.entries))
    assert [e.path for e in plan.entries] == ["im2col", "systolic",
                                              "winograd"]
    imgs = _imgs(cfg, 4, seed=5)
    x = torch.from_numpy(np.stack(imgs))
    healthy = CNNServeEngine(cfg, params, buckets=(4,), device="cpu",
                             plan=plan)
    want_healthy = healthy.forward(x).numpy()
    clk = ManualClock()
    eng = CNNServeEngine(cfg, params, buckets=(1, 4), device="cpu",
                         plan=plan, clock=clk, advance=clk.advance_to,
                         retry=RetryPolicy(max_attempts=4,
                                           backoff_base=0.001))
    real_forward, oom = eng.forward, [2]

    def flaky(xb):
        if oom[0]:
            oom[0] -= 1
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real_forward(xb)

    eng.forward = flaky
    done = _serve(eng, imgs)
    assert eng.degrade_log == ["dropped bucket 4",
                               "rerouted plan to materialized im2col"]
    fallback = planner.materialized_fallback_plan(plan)
    assert eng.plan == fallback
    with torch.inference_mode():
        want = cnn.cnn_forward(eng.params, cfg, x, plan=fallback).numpy()
    got = np.stack([done[u].logits for u in range(4)])
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - want_healthy).max() > 0


def test_cnn_engine_clock_and_faults_stats():
    """The batcher runs on the injector's warped clock; stats carry the
    injector's counts."""
    cfg = _cnn_cfg(conv_path="im2col")
    clk = ManualClock(5.0)
    eng = CNNServeEngine(cfg, _cnn_params(cfg), buckets=(2,), device="cpu",
                         clock=clk, faults=FaultInjector(
                             FaultPlan(seed=0, latency_rate=1.0,
                                       latency_s=0.25)))
    assert eng.faults._clock is clk
    _serve(eng, _imgs(cfg, 3))
    s = eng.stats()
    assert s["faults"]["injected"]["latency"] == 2
    assert s["faults"]["clock_skew_s"] == pytest.approx(0.5)
    assert eng.request_queue.now() == pytest.approx(5.5)
    assert not eng.has_work() and eng.urgency()[0] == float("inf")


# -- the cross-package ledger -------------------------------------------------

def _stub_logits(batch: np.ndarray, n_classes: int) -> np.ndarray:
    """A numpy stand-in for the forward: deterministic per row."""
    flat = batch.reshape(batch.shape[0], -1)
    return (flat[:, :n_classes] * 2.0 + flat[:, -1:]).astype(np.float32)


def test_fault_ledger_matches_the_reference_engine(monkeypatch):
    """One FaultPlan, RetryPolicy and fake clock through the reference
    CNNServeEngine and the port's, each forward stubbed (nothing jits and
    nothing convolves): the same ledger, request by request."""
    n_req = 24
    plan_kw = dict(seed=8, transient_rate=0.4, transient_fails=2,
                   poison_rate=0.1, poison_uids=(2,), oom_rate=0.1,
                   latency_rate=0.3, latency_s=0.02)
    retry_kw = dict(max_attempts=5, backoff_base=0.001)
    slos = ["interactive", None, "standard", None]
    ref_cfg = ref_reduced(ref_get_config("alexnet")).replace(
        policy=RefPolicy.KOM_INT14)
    cfg = _cnn_cfg()
    imgs = _imgs(cfg, n_req, seed=9)
    n_cls = cfg.n_classes
    monkeypatch.setattr(RefEngine, "_run_batch",
                        lambda self, b: _stub_logits(b, n_cls))
    monkeypatch.setattr(CNNServeEngine, "run_batch",
                        lambda self, b: _stub_logits(b, n_cls))
    ledgers = []
    for side in ("reference", "port"):
        clk = ManualClock()
        if side == "reference":
            # prequantize=False and no params: nothing runs in JAX
            eng = RefEngine(ref_cfg, None, prequantize=False,
                            buckets=(1, 4, 8), clock=clk,
                            faults=RefFaultPlan(**plan_kw),
                            retry=RefRetry(**retry_kw),
                            advance=clk.advance_to)
            mk = RefImage
        else:
            eng = CNNServeEngine(cfg, _cnn_params(cfg), buckets=(1, 4, 8),
                                 device="cpu", clock=clk,
                                 faults=FaultPlan(**plan_kw),
                                 retry=RetryPolicy(**retry_kw),
                                 advance=clk.advance_to)
            mk = ImageRequest
        for uid in range(n_req):
            eng.submit(mk(uid=uid, image=imgs[uid], slo=slos[uid % 4]))
            if uid % 6 == 5:     # continuous admission between steps
                eng.step()
        done = eng.run()
        q = eng.batcher.queue
        assert _conserved(q)
        s = eng.stats()
        ledgers.append({
            "done": sorted(done),
            "logits": {u: done[u].logits.tolist() for u in sorted(done)},
            "failed": {u: f.attempts for u, f in sorted(q.failed.items())},
            "expired": sorted(q.expired),
            "retries": s["retries"], "bisections": s["bisections"],
            "quarantined": s["quarantined"],
            "fault_counts": s["fault_counts"],
            "injected": s["faults"]["injected"],
            "clock_skew_s": s["faults"]["clock_skew_s"],
            "bucket_counts": s["bucket_counts"],
            "health": s["health"], "degrade_log": s["degrade_log"],
            "clock": clk.t})
    ref, port = ledgers
    assert port == ref
    # the plan exercised every path the ledger compares
    assert ref["failed"] and ref["retries"] and ref["bisections"]
    assert all(ref["injected"][k] for k in ("transient", "poison", "oom",
                                            "latency"))
    assert ref["degrade_log"] and ref["expired"]


# -- SLOs on the CNN engine (test_slo_serving.py on the port) ----------------

def _slo_engine(clock=None, buckets=(1, 4)):
    cfg = _cnn_cfg(conv_path="im2col")
    kw = {} if clock is None else {"clock": clock}
    return cfg, CNNServeEngine(cfg, _cnn_params(cfg), buckets=buckets,
                               device="cpu", **kw)


def test_cnn_engine_expires_overdue_requests_typed():
    clk = ManualClock()
    cfg, eng = _slo_engine(clock=clk)
    img0, img1 = _imgs(cfg, 2)
    eng.submit(ImageRequest(uid=0, image=img0, deadline=1.0))
    eng.submit(ImageRequest(uid=1, image=img1))
    clk.t = 2.0
    done = eng.run()
    assert sorted(done) == [1] and done[1].label is not None
    assert list(eng.expired) == [0]
    exp = eng.expired[0]
    assert isinstance(exp, Expired)
    assert exp.deadline == 1.0 and exp.expired_at >= 1.0
    assert exp.request.uid == 0 and exp.request.logits is None
    assert eng.stats()["requests_expired"] == 1


def test_cnn_engine_slo_class_resolved_at_submit():
    clk = ManualClock(10.0)
    cfg, eng = _slo_engine(clock=clk)
    img = _imgs(cfg, 1)[0]
    eng.submit(ImageRequest(uid=0, image=img, slo="interactive"))
    t = eng.request_queue.timing[0]
    assert t.slo == "interactive" and t.deadline == pytest.approx(10.050)
    assert eng.urgency()[0] == pytest.approx(10.050)
    with pytest.raises(ValueError, match="unknown SLO class"):
        eng.submit(ImageRequest(uid=1, image=img, slo="platinum"))
    cfg2 = _cnn_cfg(conv_path="im2col")
    own = CNNServeEngine(cfg2, _cnn_params(cfg2), buckets=(1,),
                         device="cpu", clock=clk,
                         slo_budgets={"platinum": 0.002})
    own.submit(ImageRequest(uid=1, image=img, slo="platinum"))
    assert own.request_queue.timing[1].deadline == pytest.approx(10.002)


def test_cnn_engine_truncated_run_raises_and_rejects_duplicates():
    cfg, eng = _slo_engine(buckets=(1,))
    imgs = _imgs(cfg, 3)
    for uid in range(3):
        eng.submit(ImageRequest(uid=uid, image=imgs[uid]))
    with pytest.raises(IncompleteRunError, match="still pending") as ei:
        eng.run(max_steps=1)
    assert sorted(ei.value.done) == [0]
    assert ei.value.pending_uids == [1, 2]
    assert sorted(eng.run()) == [0, 1, 2]
    with pytest.raises(ValueError, match="duplicate uid 2"):
        eng.submit(ImageRequest(uid=2, image=imgs[0]))


# -- the LM engine under chaos and SLOs ---------------------------------------

def _lm(arch="granite-3-2b"):
    cfg = reduced(get_config(arch)).replace(policy=MatmulPolicy.FP32,
                                            compute_dtype="float32")
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


def _prompts(cfg, n, seed=0, plen=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, (plen,)).astype(np.int32)
            for _ in range(n)]


def test_lm_engine_retries_and_quarantines():
    cfg, params = _lm()
    prompts = _prompts(cfg, 3)
    ref = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu")
    for uid in range(3):
        ref.submit(Request(uid=uid, prompt=prompts[uid], max_new_tokens=4))
    ref_done = ref.run()
    clk = ManualClock()
    eng = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu",
                      clock=clk, advance=clk.advance_to,
                      faults=FaultPlan(seed=2, transient_rate=1.0,
                                       transient_fails=1, poison_uids=(1,)),
                      retry=RetryPolicy(max_attempts=3, backoff_base=0.001))
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=prompts[uid], max_new_tokens=4))
    done = eng.run()
    assert _conserved(eng.request_queue)
    assert sorted(done) == [0, 2]
    assert list(eng.failed) == [1] and eng.failed[1].attempts >= 3
    s = eng.stats()
    assert s["retries"] > 0 and s["faults"]["injected"]["poison"] >= 3
    for uid in done:
        assert done[uid].out_tokens == ref_done[uid].out_tokens, uid


def test_lm_engine_oom_halves_slot_cap_then_downs():
    cfg, params = _lm()
    clk = ManualClock()
    eng = ServeEngine(cfg, params, slots=4, max_len=32, device="cpu",
                      clock=clk, advance=clk.advance_to,
                      retry=RetryPolicy(max_attempts=20, backoff_base=0.001))
    prompts = _prompts(cfg, 2, seed=1)
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=2))
    oom, real = [2], eng._decode

    def flaky(*a):
        if oom[0]:
            oom[0] -= 1
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(*a)

    eng._decode = flaky
    done = eng.run()
    assert eng.health == "degraded" and eng._slot_cap == 1
    assert sorted(done) == [0] and _conserved(eng.request_queue)
    eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=2))
    oom[0] = 10
    eng.run()
    assert eng.health == "down" and 1 in eng.failed
    assert _conserved(eng.request_queue)
    with pytest.raises(EngineDownError):
        eng.submit(Request(uid=2, prompt=prompts[0]))


def test_lm_engine_truncated_run_expiry_and_edf_admission():
    cfg, params = _lm()
    eng = ServeEngine(cfg, params, slots=1, max_len=32, device="cpu")
    prompts = _prompts(cfg, 3)
    for uid in range(2):
        eng.submit(Request(uid=uid, prompt=prompts[uid], max_new_tokens=4))
    with pytest.raises(IncompleteRunError, match="still pending") as ei:
        eng.run(max_steps=1)
    assert set(ei.value.pending_uids) == {0, 1}
    assert sorted(eng.run()) == [0, 1]
    clk = ManualClock()
    eng = ServeEngine(cfg, params, slots=1, max_len=32, device="cpu",
                      clock=clk)
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=2))
    eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=2,
                       deadline=1.0))
    eng.submit(Request(uid=2, prompt=prompts[2], max_new_tokens=2,
                       deadline=50.0))
    clk.t = 2.0
    done = eng.run()
    assert sorted(done) == [0, 2] and list(eng.expired) == [1]
    t = eng.request_queue.timing
    assert t[2].admitted <= t[0].admitted


# -- the dispatcher over the real port engines --------------------------------

def test_dispatcher_serves_interactive_cnn_before_lm_and_backlog():
    """A VGG16 ``batch`` backlog, then interactive AlexNet and standard
    xlstm requests on one fake clock: AlexNet drains first, every model
    conserves, each CNN's logits equal its solo engine's, the xlstm's
    tokens a solo ServeEngine's, and again under transient faults."""
    clk = ManualClock()
    alex_cfg = _cnn_cfg()
    vgg_cfg = reduced(get_config("vgg16")).replace(
        policy=MatmulPolicy.KOM_INT14)
    lm_cfg, lm_params = _lm("xlstm-125m")
    alex_p, vgg_p = _cnn_params(alex_cfg), _cnn_params(vgg_cfg, seed=1)
    alex_imgs, vgg_imgs = _imgs(alex_cfg, 4, seed=2), _imgs(vgg_cfg, 4, 3)
    prompts = _prompts(lm_cfg, 2, seed=4)

    def lm_engine(**kw):
        return ServeEngine(lm_cfg, lm_params, slots=2, max_len=16,
                           device="cpu", **kw)

    disp = MultiModelDispatcher()
    disp.register("vgg16", CNNServeEngine(vgg_cfg, vgg_p, buckets=(1, 2),
                                          device="cpu", clock=clk))
    disp.register("alexnet", CNNServeEngine(alex_cfg, alex_p,
                                            buckets=(1, 2), device="cpu",
                                            clock=clk))
    disp.register("xlstm", lm_engine(clock=clk))
    for uid, img in enumerate(vgg_imgs):
        disp.submit("vgg16", ImageRequest(uid=uid, image=img, slo="batch"))
    for uid, img in enumerate(alex_imgs):
        disp.submit("alexnet", ImageRequest(uid=10 + uid, image=img,
                                            slo="interactive"))
    for uid, p in enumerate(prompts):
        disp.submit("xlstm", Request(uid=20 + uid, prompt=p,
                                     max_new_tokens=3, slo="standard"))
    order = []
    while disp.has_work():
        order.append(disp.step())
    n_alex = disp.stats()["per_model"]["alexnet"]["dispatch_steps"]
    assert order[:n_alex] == ["alexnet"] * n_alex
    assert order.index("vgg16") > order.index("xlstm")
    s = disp.stats()
    assert s["requests_done"] == 10 and s["requests_failed"] == 0
    for name in disp.models:
        assert _conserved(disp.engine(name).request_queue), name
    for name, cfg, params, imgs, base in (
            ("alexnet", alex_cfg, alex_p, alex_imgs, 10),
            ("vgg16", vgg_cfg, vgg_p, vgg_imgs, 0)):
        solo = CNNServeEngine(cfg, params, buckets=(1,), device="cpu")
        want = _serve(solo, imgs)
        done = disp.engine(name).request_queue.done
        for i in range(len(imgs)):
            assert np.array_equal(done[base + i].logits, want[i].logits)
    solo = lm_engine()
    for uid, p in enumerate(prompts):
        solo.submit(Request(uid=20 + uid, prompt=p, max_new_tokens=3))
    want = {u: r.out_tokens for u, r in solo.run().items()}
    got = disp.engine("xlstm").request_queue.done
    assert {u: got[u].out_tokens for u in got} == want
    chaos = lm_engine(clock=clk, advance=clk.advance_to,
                      faults=FaultPlan(seed=2, transient_rate=0.5),
                      retry=RetryPolicy(backoff_base=0.001))
    for uid, p in enumerate(prompts):
        chaos.submit(Request(uid=20 + uid, prompt=p, max_new_tokens=3))
    assert {u: r.out_tokens for u, r in chaos.run().items()} == want
    assert chaos.stats()["faults"]["injected"]["transient"] > 0


# -- grep contract and the launcher -------------------------------------------

def test_no_direct_sleep_or_monotonic_calls_in_serving_paths():
    """Backoff and fault timing run on the injected ``clock=``; a direct
    ``time.sleep``/``time.monotonic()`` call would decouple them.  A
    reference such as ``clock or time.monotonic`` is fine."""
    targets = sorted((PORT / "serving").glob("*.py"))
    targets.append(PORT / "launch" / "serve.py")
    assert len(targets) >= 7
    call = re.compile(r"\btime\.(?:sleep|monotonic)\s*\(")
    bad = [f"{p.name}:{i}: {line.strip()}" for p in targets
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if call.search(line)]
    assert not bad, "direct time.* calls in serving paths:\n" + "\n".join(bad)


def test_launcher_serves_two_models_under_faults_on_cpu(capsys):
    from repro_torch.launch.serve import main
    rc = main(["--arch", "alexnet,vgg16", "--reduced", "--device", "cpu",
               "--fault-plan", "transient=0.5,poison=0.1", "--requests",
               "4", "--slo", "standard"])
    assert rc == 0
    out = capsys.readouterr().out
    fleet = [ln for ln in out.splitlines() if ln.startswith(
        "[serve] fleet:")]
    assert len(fleet) == 1 and "across 2 models" in fleet[0]
    assert "alexnet:" in out and "vgg16:" in out


@pytest.mark.parametrize("argv, match", [
    (["--fault-plan", "bogus=1"], "--fault-plan: unknown fault spec key"),
    (["--fault-plan", "poison=2"], "--fault-plan: poison_rate"),
    (["--retries", "0"], "--retries: max_attempts"),
    (["--arch", "alexnet,lenet"], "--arch: unknown"),
    (["--arch", "alexnet,alexnet"], "names a model twice"),
    (["--slo", "platinum"], "invalid choice"),
])
def test_launcher_refuses_bad_flags_at_parse_time(argv, match, capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as ei:
        main(argv + ["--reduced", "--device", "cpu"])
    assert ei.value.code == 2
    assert match in capsys.readouterr().err


def test_launcher_tally_prints_expired_requests(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "alexnet", "--reduced", "--device", "cpu",
                 "--requests", "3", "--deadline-ms", "0"]) == 0
    out = capsys.readouterr().out
    assert out.count("EXPIRED") == 3 and "expired 3" in out
