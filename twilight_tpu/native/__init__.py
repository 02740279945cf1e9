"""Native host-side modules, compiled on demand and bound with ctypes.

A build lands in `build/` next to the sources, under a name keyed on the
source bytes, the compiler flags and the host it was built for, so a
library built elsewhere (another CPU, other flags, an older source) is
never loaded: it simply has another name, and this host builds its own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Sequence

_DIR = os.path.dirname(__file__)
BUILD_DIR = os.path.join(_DIR, "build")
_LOCK = threading.Lock()
_LIBS = {}

# NOTE: float semantics are load-bearing (bit-exact parity with the
# reference build): keep IEEE ordering — no -ffast-math, explicit
# -ffp-contract=off (no FMA fusing).
CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
            "-std=c++17"]


def host_id() -> str:
    """What a binary built with -march=native depends on: the machine and
    the CPU's model and feature flags (first processor's block)."""
    cpu = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                if line.startswith(("model name", "flags", "Features",
                                    "CPU part")):
                    cpu.append(line.strip())
    except OSError:
        pass
    return "|".join([platform.system(), platform.machine()] + cpu)


def build_key(sources: Sequence[str], flags: Sequence[str],
              extra: str = "") -> str:
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    h.update(host_id().encode())
    h.update(extra.encode())
    return h.hexdigest()[:16]


def built_path(name: str, sources: Sequence[str], flags: Sequence[str],
               extra: str = "") -> str:
    """Where the library for these sources, flags and host lives."""
    return os.path.join(BUILD_DIR, f"lib{name}-"
                        f"{build_key(sources, flags, extra)}.so")


def build(cmd_for, so: str) -> None:
    """Run `cmd_for(out_path)` into a private file, then move it into
    place, so concurrent processes never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"build of {os.path.basename(so)} failed:\n"
                               f"{r.stderr[-4000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def lib_path(name: str) -> str:
    return built_path(name, [os.path.join(_DIR, name + ".cpp")], CXXFLAGS)


def load(name: str):
    """Compile (if needed) and load lib<name>.so for this host.
    Returns the ctypes CDLL, or None if no toolchain is available."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(_DIR, name + ".cpp")
        so = lib_path(name)
        if not os.path.exists(so):
            try:
                build(lambda out: ["g++", *CXXFLAGS, src, "-o", out], so)
            except Exception:
                _LIBS[name] = None
                return None
        try:
            _LIBS[name] = ctypes.CDLL(so)
        except OSError:
            _LIBS[name] = None
        return _LIBS[name]
