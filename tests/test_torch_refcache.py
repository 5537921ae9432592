"""A cache of the JAX reference's results, shared by the workers of one run.

The port's tests hold it against the reference's own functions, and most of
their time is the reference's: ``jax.random`` inits and ``jax.jit`` of whole
reduced models, whose XLA compiles take tens of seconds each.  Under
``pytest -n N`` the tests that need one result land on different workers,
and each worker computed it again.  :func:`cached` computes each result once
per run: the first worker to ask takes a lock file (``O_CREAT | O_EXCL``)
in the session's base temporary directory (shared by the workers), computes
the value and writes it there; the others wait for the file and read it.
Values are pickled numpy trees, so what a test compares is bit for bit what
the reference returned.  Keys name what was computed (model, policy, path,
seed) and carry a digest of the inputs (:func:`digest`).  Outside a pytest
session (no base directory) the cache is this process's memory alone.

The tests below hold the cache itself: a value round-trips bit for bit,
the second caller reads the first one's file, a caller that finds the lock
waits for the holder's value, a computation that raises leaves neither a
value nor a lock behind, and a lock left by a dead worker stalls no one.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import pickle
import threading
import time

import numpy as np
import pytest

#: Where the shared files go (set by :func:`refcache_session`); None: the
#: cache is this process's memory alone.
_DIR: pathlib.Path | None = None
_memo: dict = {}
#: How long a waiter waits for the lock holder before computing itself.
WAIT_S = 900.0


@pytest.fixture(scope="session", autouse=True)
def refcache_session(tmp_path_factory):
    """Points the cache at the run's shared base temporary directory (under
    xdist each worker's base directory is a child of it).  Autouse: a test
    module takes it by importing it."""
    global _DIR
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    _DIR = base / "refcache"
    _DIR.mkdir(exist_ok=True)
    yield
    _DIR = None


def digest(*trees) -> str:
    """A short hash of numpy arrays (in nested lists, tuples and dicts):
    their dtypes, shapes and bytes."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(repr(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[")
            for v in x:
                walk(v)
            h.update(b"]")
        else:
            a = np.ascontiguousarray(np.asarray(x))
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
    for t in trees:
        walk(t)
    return h.hexdigest()[:16]


def _read(path: pathlib.Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def cached(kind: str, key: tuple, compute):
    """``compute()``, once per run for ``(kind, key)``: from this process's
    memory, else from the shared file, else computed here (under the lock)
    and written there; a worker that finds the lock taken waits for the
    file (and computes itself if the holder fails, dies or takes longer
    than :data:`WAIT_S`)."""
    name = f"{kind}-{hashlib.sha256(repr(key).encode()).hexdigest()[:20]}"
    if name in _memo:
        return _memo[name]
    base = _DIR
    if base is None:
        value = compute()
    else:
        path, lock = base / f"{name}.pkl", base / f"{name}.lock"
        value = _read(path) if path.exists() else _compute_shared(
            path, lock, compute)
    _memo[name] = value
    return value


def _holder_alive(lock) -> bool:
    """Whether the process that wrote its pid into ``lock`` still runs (a
    worker that died while computing leaves its lock behind)."""
    try:
        os.kill(int(lock.read_text() or 0) or os.getpid(), 0)
    except (OSError, ValueError):
        return False
    return True


def _compute_shared(path, lock, compute):
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        t0 = time.monotonic()
        while time.monotonic() - t0 < WAIT_S:
            if path.exists():
                return _read(path)
            if not lock.exists() or not _holder_alive(lock):
                break  # the holder failed or died: no value
            time.sleep(0.05)
        return compute()
    os.write(fd, str(os.getpid()).encode())
    os.close(fd)
    try:
        value = compute()
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # readers see the whole file or none
        return value
    finally:
        lock.unlink()


def init_numpy(kind: str, key: tuple, init):
    """The reference's params ``init()`` as a numpy tree, once per run for
    ``(kind, key)``; each call gets its own copy of the arrays (the port's
    params share memory with them)."""
    import jax

    tree = cached(kind, key, lambda: jax.tree.map(np.asarray, init()))
    return jax.tree.map(np.array, tree)


def cnn_init_numpy(ref_cfg, seed: int) -> list:
    """``ref_cnn.cnn_init(ref_cfg, PRNGKey(seed))`` as numpy, once per run
    for the layers it depends on (not the policy or conv path)."""
    import jax

    from repro.models import cnn as ref_cnn

    key = (ref_cfg.name, tuple(map(tuple, ref_cfg.layers)),
           ref_cfg.in_channels, ref_cfg.img_size, seed)
    return init_numpy("cnn-init", key, lambda: ref_cnn.cnn_init(
        ref_cfg, jax.random.PRNGKey(seed)))


# -- the cache itself ----------------------------------------------------------

@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """An empty cache directory and memory for one test."""
    monkeypatch.setattr(__import__(__name__), "_DIR", tmp_path)
    monkeypatch.setattr(__import__(__name__), "_memo", {})
    return tmp_path


def test_cached_value_round_trips_bit_for_bit(fresh):
    rng = np.random.default_rng(0)
    tree = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
             "b": np.array([np.nan, -0.0, 1e-45], np.float32)}, {}]
    got = cached("t", ("a", 1), lambda: tree)
    assert got is tree
    _memo.clear()
    again = cached("t", ("a", 1), lambda: pytest.fail("computed twice"))
    assert again is not tree
    assert digest(again) == digest(tree)
    for p, q in zip(again, tree):
        for k in q:
            assert p[k].tobytes() == q[k].tobytes()
    assert not list(fresh.glob("*.lock"))


def test_digest_tells_inputs_apart():
    a = np.arange(6, dtype=np.float32)
    assert digest(a) == digest(a.copy())
    assert digest(a) != digest(a.reshape(2, 3))
    assert digest(a) != digest(a.astype(np.float64))
    assert digest([a], {"x": a}) != digest([a], {"y": a})


def test_waiter_reads_the_lock_holders_value(fresh):
    """A second caller that finds the lock waits for the holder's file and
    returns it without computing."""
    started, release = threading.Event(), threading.Event()

    def slow():
        started.set()
        release.wait(10)
        return np.array([7.0])

    holder = threading.Thread(target=cached, args=("w", (1,), slow))
    holder.start()
    assert started.wait(10)
    _memo.clear()
    out = {}
    waiter = threading.Thread(target=lambda: out.setdefault(
        "v", cached("w", (1,), lambda: pytest.fail("waiter computed"))))
    waiter.start()
    time.sleep(0.2)
    assert "v" not in out  # still waiting on the holder
    release.set()
    holder.join(10)
    waiter.join(10)
    assert out["v"].tolist() == [7.0]


def test_failed_computation_leaves_no_value_or_lock(fresh):
    def boom():
        raise RuntimeError("reference failed")

    with pytest.raises(RuntimeError, match="reference failed"):
        cached("f", (2,), boom)
    assert not list(fresh.iterdir())
    assert cached("f", (2,), lambda: 3) == 3


def test_lock_of_a_dead_worker_does_not_stall(fresh):
    """A lock left by a process that no longer runs: the caller computes
    the value itself at once instead of waiting for it."""
    import subprocess
    import sys
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True, check=True)
    name = f"d-{hashlib.sha256(repr((3,)).encode()).hexdigest()[:20]}"
    (fresh / f"{name}.lock").write_text(dead.stdout.strip())
    t0 = time.monotonic()
    assert cached("d", (3,), lambda: 5) == 5
    assert time.monotonic() - t0 < 5
