"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers:
a build takes seconds, not minutes).  Builds happen at first use, never at
import, into ``repro_torch/_build/`` (git-ignored), keyed by a digest of the
sources and flags so a stale library is never loaded.  :func:`build` starts
one ``nvcc`` per source, all at once.

``-fmad=false`` keeps the compiler from contracting a multiply and an add
into an FMA anywhere; where the arithmetic IS an FMA -- the integer
kernels' dequant-plus-bias epilogue (``csrc/limb_tile.cuh``) and every
multiply-add of the float kernels (``csrc/float_tile.cuh``) -- the source
writes ``__fmaf_rn`` explicitly.  ``--use_fast_math`` is never used: it
would turn the quantizer's IEEE division into an approximation.

Every wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a run can show that the serving path went through
the kernels.  Inside :func:`plain_versions` the wrappers run their plain
PyTorch versions on any device instead -- the explicit, scoped switch that
lets a run hold the whole model's kernels against their plain versions on
the card.  Outside it, a CUDA tensor always goes to its kernel.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

#: Library name -> CUDA source; every source includes the shared headers.
SOURCES = {
    "kom_matmul": "kom_matmul.cu",
    "bf16_matmul": "bf16_matmul.cu",
    "implicit_conv": "implicit_conv.cu",
    "implicit_conv_float": "implicit_conv_float.cu",
    "systolic_conv": "systolic_conv.cu",
    "winograd": "winograd.cu",
    "flash_attention": "flash_attention.cu",
    "flash_decode": "flash_decode.cu",
    "mlstm_chunk": "mlstm_chunk.cu",
}
HEADERS = ("limb_tile.cuh", "limb_mma.cuh", "conv_mma.cuh",
           "float_tile.cuh", "tf32x3.cuh")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

#: Kernel launches per wrapper name since the last :func:`reset_launches`.
LAUNCHES: collections.Counter = collections.Counter()

_libs: dict = {}
_ptxas: dict = {}
_lock = threading.Lock()
_plain = contextvars.ContextVar("repro_torch_plain_versions", default=False)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default location; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names=None) -> dict:
    """Compile the named libraries (default: all) that are not built yet.

    One ``nvcc`` process per source, all started together.  Returns
    ``{name: seconds}`` for the libraries compiled by this call; raises
    with the compiler's output if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{n}-",
                                   suffix=".so")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    took, errors = {}, []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        _ptxas[n] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {SOURCES[n]} "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def sass_count(name: str, pattern: str) -> int:
    """SASS instructions of the built library ``name`` (``cuobjdump -sass``,
    from the toolkit beside ``nvcc``) whose opcode matches ``pattern``: how
    a run shows which units a kernel uses (``HGMMA``: bf16 wgmma, ``HMMA``:
    bf16 or TF32 mma.sync, ``IMMA``: int8 mma.sync)."""
    import re
    tool = pathlib.Path(nvcc_path()).parent / "cuobjdump"
    build([name])
    out = subprocess.run([str(tool), "-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    rx = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(" + pattern
                    + r")\b")
    return sum(1 for line in out.splitlines() if rx.search(line))


def compiler_report(name: str) -> list[tuple[str, str]]:
    """What ``nvcc -Xptxas=-v`` said when this process built ``name`` (empty
    if it did not): ``(kernel, line)`` for each compiled kernel's registers,
    stack and spills (``kernel`` is its mangled name), and ``("", line)``
    for each warning, such as ptxas's performance warnings."""
    out, kernel = [], None
    for line in _ptxas.get(name, "").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif "Performance Loss" in line or "warning" in line:
            out.append(("", line.strip()))
        elif kernel and ("registers" in line or "spill" in line):
            out.append((kernel, line.split("info    :")[-1].strip()))
    return out


def spills(line: str) -> bool:
    """Whether a :func:`compiler_report` line reports spilled registers."""
    return "spill" in line and "0 bytes spill stores, 0 bytes spill loads" \
        not in line


def library(name: str, argtypes: dict) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed.

    ``argtypes`` maps each exported function to its ctypes argument types
    (pointers as ``c_void_p``, so 64-bit addresses are never cut), or to
    ``(argument types, result type)`` where the result is not a C int.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            for fn, types in argtypes.items():
                types, restype = (types if isinstance(types, tuple)
                                  else (types, ctypes.c_int))
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({code})")


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    """Device address of a tensor, or None (a NULL pointer) for None."""
    return None if t is None else t.data_ptr()


def use_kernel(t: torch.Tensor) -> bool:
    """True when a wrapper must launch its CUDA kernel for tensor ``t``."""
    return t.is_cuda and not _plain.get()


@contextlib.contextmanager
def plain_versions():
    """Run every kernel wrapper's plain PyTorch version, on any device."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)


def reset_launches() -> None:
    LAUNCHES.clear()


def launch_counts() -> dict:
    return dict(LAUNCHES)
