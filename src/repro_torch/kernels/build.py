"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` into ``build/repro_torch/<name>-<hash>.so`` under the
checkout's root, keyed by a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, then loaded with ``ctypes``. Nothing here
runs at import time: the CPU tests import every module on a host without
``nvcc``. A failed build raises. Every function takes ``csrc``, another
directory of sources with the same C entry points (an earlier version of
a kernel, timed beside the current one); it defaults to the package's own.

A launch resolves its entry point once: the library, the function and its
``argtypes`` are cached per ``(csrc, name, symbol)``, so a call only
passes its arguments and the current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[tuple[Path, str], ctypes.CDLL] = {}
_ENTRY_POINTS: dict[tuple[Path, str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives for the current source."""
    digest = hashlib.sha256()
    digest.update((Path(csrc) / f"{name}.cu").read_bytes())
    for header in sorted(Path(csrc).glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names, csrc: Path = CSRC) -> dict[str, float]:
    """Compile every named source that has no current build, one ``nvcc``
    per source, all started together. Returns seconds per source built
    (0.0 for a build that already existed). Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(Path(csrc) / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    times = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    key = (Path(csrc), name)
    lib = _LIBS.get(key)
    if lib is None:
        build([name], csrc)
        lib = ctypes.CDLL(str(library_path(name, csrc)))
        _LIBS[key] = lib
    return lib


def entry_point(name: str, symbol: str, args, csrc: Path = CSRC):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, resolved once:
    built and loaded if needed, its ``argtypes`` set from ``args`` (a
    tensor or ``None`` passes as a pointer, anything else as a C int) plus
    the trailing stream, its ``restype`` a C int."""
    key = (csrc, name, symbol)
    fn = _ENTRY_POINTS.get(key)
    if fn is None:
        fn = getattr(load(name, csrc), symbol)
        fn.argtypes = [ctypes.c_void_p if arg is None or isinstance(arg, torch.Tensor)
                       else ctypes.c_int for arg in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY_POINTS[key] = fn
    return fn


def launch(name: str, symbol: str, args, device, csrc: Path = CSRC) -> None:
    """Call the C entry point ``symbol`` of ``csrc/<name>.cu`` on the
    current stream of ``device``. ``args`` are the entry point's arguments
    before its trailing stream: tensors pass their data pointer (``None``
    a null one), Python ints pass as C ints. ``device`` is a tensor's
    device; it becomes the current one for the call only when it is not
    already. Raises when the entry point returns a CUDA error."""
    fn = entry_point(name, symbol, args, csrc)
    values = [arg.data_ptr() if isinstance(arg, torch.Tensor) else arg for arg in args]
    # the current stream as a plain int, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream
    if device.index == torch.cuda.current_device():
        rc = fn(*values, stream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*values, stream(device.index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
