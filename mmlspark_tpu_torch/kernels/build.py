"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point. It is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``_build/`` (listed in ``.gitignore``), named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is a cache
hit. Nothing here includes PyTorch's headers: a build takes seconds, not
minutes. :func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing is compiled or loaded at import: the CPU tests import every
module, and a machine without a card has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

KERNELS: List["Kernel"] = []


class Kernel:
    """One hand-written CUDA kernel behind a plain C entry point.

    ``launches`` counts the kernel's successful launches in this process;
    :meth:`__call__` is the only place it grows. ``argtypes`` are the
    ctypes types of the entry point's arguments: ``c_void_p`` for every
    pointer and the stream, ``c_int`` for ints. The entry point returns
    ``cudaGetLastError()``, and a nonzero value raises. ``build_log`` holds
    what nvcc printed (registers, shared memory and spills per kernel, from
    ``-Xptxas=-v``) when the library was built, kept beside it as
    ``<library>.log``; :func:`ptxas_report` reads it.
    ``variant_launches`` splits ``launches`` by the variant a wrapper names
    when it launches one of several kernels behind the entry point."""

    def __init__(self, name: str, source, argtypes: Sequence):
        self.name = name
        self.source = CSRC / source   # a name under csrc/, or a full path
        self.argtypes = list(argtypes)
        self.launches = 0
        self.variant_launches: Dict[str, int] = {}
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()
        KERNELS.append(self)

    def library(self) -> Path:
        """Where this source's build lands (it may not exist yet)."""
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _entry(self):
        with self._lock:
            if self._fn is None:
                self._fn = self.symbol(self.name, self.argtypes)
            return self._fn

    def symbol(self, name: str, argtypes: Sequence):
        """The C function ``name`` of this kernel's library (built first if
        missing), returning an int. Calls through it are not counted: the
        library's other entry points (an empty kernel on the same grid, to
        time the launch floor) are measurement aids, not launches."""
        build_all([self])
        fn = getattr(ctypes.CDLL(str(self.library())), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args, variant: str = None) -> None:
        """Launch once (asynchronously, on the stream passed in ``args``),
        counted under ``variant`` too when one is named."""
        rc = self._entry()(*args)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {rc}")
        with self._lock:
            self.launches += 1
            if variant is not None:
                self.variant_launches[variant] = \
                    self.variant_launches.get(variant, 0) + 1


def nvcc() -> str:
    """Path of the CUDA toolkit's nvcc, as PyTorch's C++ extension tooling
    finds it (CUDA_HOME / CUDA_PATH, then PATH, then the default
    install location)."""
    from torch.utils.cpp_extension import CUDA_HOME
    found = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
             else shutil.which("nvcc"))
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use and need the "
                           "CUDA toolkit")
    return found


def build_all(kernels: Sequence[Kernel] = None) -> Dict[str, str]:
    """Build every kernel whose library is missing, one ``nvcc`` process
    per source, all started together. Returns ``{name: "hit" | "built"}``.
    Each library is written under a temporary name and renamed into place,
    so concurrent builds never load a half-written file."""
    kernels = list(KERNELS if kernels is None else kernels)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    status, procs = {}, []
    for k in kernels:
        lib = k.library()
        if lib.exists():
            status[k.name] = "hit"
            log = lib.with_suffix(".log")
            k.build_log = log.read_text() if log.exists() else ""
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(k.source)]
        procs.append((k, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for k, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            k.build_log = out.decode(errors="replace")
            lib.with_suffix(".log").write_text(k.build_log)
            os.replace(tmp, lib)
            status[k.name] = "built"
        else:
            os.unlink(tmp)
            failures.append(f"{k.source.name}:\n{out.decode(errors='replace')}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return status


_PTXAS_FUNCTION = re.compile(
    r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?")
_PTXAS_SPILLS = re.compile(
    r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGISTERS = re.compile(r"Used (\d+) registers")


def ptxas_report(build_log: str) -> Dict[str, Dict[str, int]]:
    """What ``-Xptxas=-v`` says of each compiled function, from nvcc's
    output: ``{function: {"registers": n, "spill_stores": bytes,
    "spill_loads": bytes}}``, keyed by the (mangled) name that ptxas's
    "Compiling entry function '...'" or "Function properties for ..." line
    gives the numbers that follow it."""
    report: Dict[str, Dict[str, int]] = {}
    current = None
    for line in build_log.splitlines():
        found = _PTXAS_FUNCTION.search(line)
        if found:
            current = report.setdefault(found.group(1), {
                "registers": 0, "spill_stores": 0, "spill_loads": 0})
            continue
        if current is None:
            continue
        spills = _PTXAS_SPILLS.search(line)
        if spills:
            current["spill_stores"] = int(spills.group(1))
            current["spill_loads"] = int(spills.group(2))
        registers = _PTXAS_REGISTERS.search(line)
        if registers:
            current["registers"] = int(registers.group(1))
    return report


def demangle(names: Sequence[str]) -> List[str]:
    """C++ names as the CUDA toolkit's ``cu++filt`` spells them, without
    their argument lists (the names unchanged where it fails)."""
    names = list(names)
    tool = os.path.join(os.path.dirname(nvcc()), "cu++filt")
    if not names or not os.path.exists(tool):
        return names
    done = subprocess.run([tool, "-p", *names], capture_output=True,
                          text=True, timeout=60)
    out = done.stdout.splitlines()
    return out if done.returncode == 0 and len(out) == len(names) else names


def reset_launches() -> None:
    """Set every kernel's launch counts to 0."""
    for k in KERNELS:
        k.launches = 0
        k.variant_launches.clear()
