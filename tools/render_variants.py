"""Times variants of the K7/K8 render layout against a parent checkout on one
NVIDIA GPU, in turns, with ``tools/ab_kernels.py --only k7,k8``.

    python3 tools/render_variants.py PARENT NAME=CONST:VALUE[,CONST:VALUE] ...

Each variant is a copy of this checkout's ``fpyv_tpu_torch`` under
``build/variants/NAME/`` (git-ignored) in which every ``constexpr int CONST
= ...;`` of ``csrc/`` gets VALUE (``kRolloutPixels:8`` renders 8 pixels a
thread), built there at its first use. ``.`` as a variant is this checkout
unchanged. The runs go PARENT, the variants in order, the variants in
reverse order, PARENT, so that a drift of the card's clock over the call
shows as a difference between the two runs of one root; each prints
``ab_kernels.py``'s JSON line after its name.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def make_variant(name: str, spec: str) -> Path:
    """build/variants/NAME with the constants of ``spec`` replaced."""
    root = HERE / "build" / "variants" / name
    pkg = root / "fpyv_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(HERE / "fpyv_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for item in spec.split(","):
        const, value = item.split(":")
        pattern = re.compile(rf"(constexpr int {re.escape(const)} = )[^;]+;")
        hits = 0
        for src in sorted((pkg / "csrc").iterdir()):
            text, n = pattern.subn(rf"\g<1>{value};", src.read_text())
            if n:
                src.write_text(text)
                hits += n
        if hits != 1:
            raise SystemExit(f"{const}: {hits} definitions in csrc/, expected 1")
    return root


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    roots = []
    for arg in sys.argv[2:]:
        name, _, spec = arg.partition("=")
        roots.append((name, HERE if name == "." else make_variant(name, spec)))
    order = [("parent", parent)] + roots + roots[::-1] + [("parent", parent)]
    rc = 0
    for name, root in order:
        run = subprocess.run([sys.executable, str(HERE / "tools" / "ab_kernels.py"), str(root),
                              "--only", "k7,k8"], capture_output=True, text=True)
        line = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
        print(f"{name} {line}", flush=True)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
            rc = run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
