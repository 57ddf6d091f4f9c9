"""Regenerate requirements-lock.txt from the current environment.

Walks the installed dependency closure of totton-tpu's declared
dependencies (core + every extra + pytest) and pins exact versions —
the moral equivalent of the reference's uv.lock
(/root/reference/uv.lock, consumed by scripts/deployment/run_tests.sh:14).
CI and release builds install from the lock so a jax/jaxlib minor bump
can never silently change XLA fusion behavior under the recorded
performance numbers.

  python scripts/freeze_lock.py > requirements-lock.txt
"""

from __future__ import annotations

import re
import sys
from importlib import metadata

ROOTS = ["numpy", "scipy", "jax", "pyzmq", "aiohttp", "jinja2",
         "matplotlib", "h5py", "pytest", "jaxlib"]


def walk(name: str, seen: dict[str, str]) -> None:
    name = re.split(r"[\[<>=!;~ ]", name, 1)[0].strip().lower()
    if not name or name in seen:
        return
    try:
        dist = metadata.distribution(name)
    except metadata.PackageNotFoundError:
        return
    seen[name] = dist.version
    for req in dist.requires or []:
        if "extra" in req.split(";")[-1]:
            continue  # optional features we don't enable
        walk(req.split(";")[0], seen)


def main() -> int:
    seen: dict[str, str] = {}
    for r in ROOTS:
        walk(r, seen)
    print("# Reproducible environment lock for totton-tpu")
    print("# (CI and release builds install from it;")
    print("# reference analog: /root/reference/uv.lock consumed by")
    print("# scripts/deployment/run_tests.sh). Pinned to the environment "
          "every")
    print(f"# performance number was measured in (python "
          f"{sys.version.split()[0]}).")
    print("# Install: pip install -r requirements-lock.txt")
    print("# Regenerate: python scripts/freeze_lock.py > "
          "requirements-lock.txt")
    for k in sorted(seen):
        print(f"{k}=={seen[k]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
