"""Build the native host-runtime helper (_fastio) for the port.

Compiles the port's copy of the JAX package's C source,
`amira_tpu_torch/native/_fastio.c`, into `amira_tpu_torch/_build/` and loads
it with importlib. `load()` returns the module, or None
when the build fails (callers then use their pure-Python fallbacks, as the
JAX package does); set AMIRA_TPU_NO_NATIVE to skip it.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading

from .. import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_fastio.c")


def _so_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, "_fastio" + suffix)


def build(force: bool = False) -> str | None:
    so = _so_path()
    if (
        not force
        and os.path.exists(so)
        and os.path.getmtime(so) >= os.path.getmtime(_SRC)
    ):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC", "gcc")
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cc, "-O2", "-fPIC", "-shared", "-o", tmp, _SRC, f"-I{include}", "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        detail = getattr(e, "stderr", "") or ""
        sys.stderr.write(
            f"amira-tpu-torch: native build failed ({e}) {detail.strip()}; "
            "using Python fallbacks\n"
        )
        return None
    os.replace(tmp, so)
    return so


_module = None
_tried = False
_load_lock = threading.Lock()


def load():
    """The built module, or None (built and loaded once per process; threads
    that call it together wait for the first)."""
    if _tried:
        return _module
    with _load_lock:
        return _load_locked()


def _load_locked():
    global _module, _tried
    if not _tried:
        try:
            _module = _build_and_import()
        finally:
            # set last: load() reads _module without the lock once _tried is
            # set
            _tried = True
    return _module


def _build_and_import():
    if os.environ.get("AMIRA_TPU_NO_NATIVE"):
        return None
    so = build()
    if so is None:
        return None
    # the extension's init symbol is PyInit__fastio, so the module's last
    # name component must be _fastio
    loader = importlib.machinery.ExtensionFileLoader(f"{__package__}._fastio", so)
    spec = importlib.util.spec_from_file_location(
        f"{__package__}._fastio", so, loader=loader
    )
    try:
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
    except ImportError:
        return None
    return module
