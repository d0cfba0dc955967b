"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one generated translation unit that includes a
hand-written template from ``csrc/`` and exposes a plain C interface.
It is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

into the build directory (``build/repro_torch/`` at the repository
root, or ``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source, the
templates and the flags, so an unchanged kernel is never rebuilt.
``compile_all`` starts one nvcc per source at once.  ptxas's resource
report (registers, shared memory, spills) is kept beside each library
as ``<name>.log``.

The C entry points take pointers and the stream as ``c_void_p`` and
return ``cudaGetLastError()``; the caller raises when it is not 0
(``check``).  ``Library`` holds one hand-written kernel's fixed
translation unit, built and bound at first use (the keyed kernels
``fused_kmeans`` and ``groupby_fold`` make one per shape and plan).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from ..device import StickyCudaError

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels build with the "
                       "CUDA toolkit (set CUDA_HOME)")


def _templates_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def library_path(name: str, source: str) -> Path:
    """Where the library built from ``source`` lives (content-keyed)."""
    h = hashlib.sha256()
    for part in (source, _templates_digest(), " ".join(NVCC_FLAGS)):
        h.update(part.encode())
    return build_dir() / f"{name}_{h.hexdigest()[:16]}.so"


def compile_all(items: Sequence[Tuple[str, str]]) -> List[Path]:
    """Build every ``(name, source)`` not yet built, one nvcc per source,
    all started together.  Returns the library paths in order; raises
    with nvcc's output if any build fails."""
    out = [library_path(name, src) for name, src in items]
    todo = []
    for (name, src), so in zip(items, out):
        if so.exists() or any(so == t[0] for t in todo):
            continue
        todo.append((so, src))
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    compile_all.builds += len(todo)
    procs = []
    for so, src in todo:
        cu = so.with_suffix(".cu")
        cu.write_text(src)
        tmp = so.with_name(so.name + f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(cu)]
        procs.append((so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for so, tmp, proc in procs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{so.name}:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


compile_all.builds = 0   # nvcc processes started


def load(name: str, source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    (so,) = compile_all([(name, source)])
    key = str(so)
    if key not in _LIBS:
        _LIBS[key] = ctypes.CDLL(key)
    return _LIBS[key]


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it in fresh storage when it starts off a
    16-byte boundary (16-byte loads, ``cp.async`` and TMA need one)."""
    return t.clone() if t.data_ptr() % 16 else t


def pointers(ptrs: Sequence[int]):
    """A C array of device pointers, kept alive by the caller."""
    return (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)


# appended to every translation unit: the message of a CUDA error code
ERROR_STRING = '''
extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
'''


def bind(lib, argtypes: Dict[str, list]):
    """Declare the C entry points of a loaded kernel library (each
    returns a CUDA error code) and its ``error_string``."""
    for name, args in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


# cudaError_t codes after which the context is unusable: illegal
# address (700), launch timeout (702), device assert (710), hardware
# stack error (714), illegal instruction (715), misaligned address
# (716), invalid address space (717), invalid PC (718), launch failure
# (719), uncorrectable ECC (214)
STICKY_CODES = frozenset({214, 700, 702, 710, 714, 715, 716, 717, 718,
                          719})


def check(lib, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error: a
    ``StickyCudaError`` when the error poisons the context
    (``STICKY_CODES``), else ``RuntimeError`` (e.g. a launch
    configuration the card refuses)."""
    if rc != 0:
        msg = lib.error_string(rc).decode()
        text = f"{what}: CUDA error {rc} ({msg})"
        if rc in STICKY_CODES:
            raise StickyCudaError(text)
        raise RuntimeError(text)


class Library:
    """One hand-written kernel's library: a translation unit that
    includes its ``csrc`` header and exports ``extern "C"`` entry points.
    Most take their block sizes at run time, so one library serves every
    plan; the keyed kernels generate one per shape and plan.  It is
    built and bound at first use; what a launch needs that is fixed per
    card (persistent block counts, zero rows) is kept so that a launch
    does no other host work."""

    def __init__(self, name: str, source: str, argtypes: Dict[str, list]):
        self.name = name
        self.source = source + ERROR_STRING
        self.argtypes = argtypes
        self._lib = None
        self._layout = None
        self._per_card: Dict[Tuple, int] = {}
        self._zeros: Dict[Tuple, torch.Tensor] = {}

    def __call__(self, fn: str, *args) -> None:
        """Call the entry point ``fn``; raise on a CUDA error."""
        if self._lib is None:
            self._lib = bind(load(self.name, self.source), self.argtypes)
        check(self._lib, getattr(self._lib, fn)(*args), f"{self.name} {fn}")

    def persistent_ctas(self, dev: torch.device, variant: int, smem: int,
                        steps: int) -> int:
        """Blocks of a persistent launch of kernel ``variant`` with
        ``smem`` bytes of dynamic shared memory: as many per SM as
        occupancy allows (the entry point ``per_sm``, which calls
        ``tcopy::blocks_per_sm``), at most one per grid step.  Raises
        before building when the card allows a block fewer bytes."""
        key = (dev, variant, smem)
        if key not in self._per_card:
            props = torch.cuda.get_device_properties(dev)
            if smem > props.shared_memory_per_block_optin:
                raise ValueError(
                    f"{self.name} needs {smem} B of shared memory per block;"
                    f" the card allows {props.shared_memory_per_block_optin}"
                    " B")
            n = ctypes.c_int(0)
            with torch.cuda.device(dev):
                self("per_sm", variant, smem, ctypes.byref(n))
            self._per_card[key] = n.value * props.multi_processor_count
        return max(1, min(self._per_card[key], steps))

    def check_layout(self, smem: int) -> None:
        """Raise unless the library's own layout (its entry point
        ``layout``) uses ``smem`` bytes of shared memory a block, as the
        wrapper's Python rule says; asked once per library."""
        if self._layout is None:
            n = ctypes.c_int(0)
            self("layout", ctypes.byref(n))
            self._layout = n.value
        if self._layout != smem:
            raise RuntimeError(f"{self.name}: the library's layout takes "
                               f"{self._layout} B of shared memory, the "
                               f"wrapper's rule {smem} B")

    def combine(self, partials: torch.Tensor) -> torch.Tensor:
        """The per-block partials ``(ctas, width)`` summed in block order
        by ``fdag::combine_partials`` (the entry point ``combine``)."""
        ctas, width = partials.shape
        dev = partials.device
        if (dev, width) not in self._zeros:
            self._zeros[(dev, width)] = torch.zeros(width, device=dev)
        out = torch.empty(width, dtype=torch.float32, device=dev)
        self("combine", partials.data_ptr(),
             self._zeros[(dev, width)].data_ptr(), out.data_ptr(), ctas,
             width, torch.cuda.current_stream(dev).cuda_stream)
        return out
