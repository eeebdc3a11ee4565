"""Instructions in the loops of a built kernel library, from its SASS.

    python -m quantnet_torch.bench.sass_loops [depthwise_conv] [--match Li3ELb1ELi1E]

Builds the named library (quantnet_torch/_build.py) if it is not built,
disassembles it with `cuobjdump -sass` and prints, for each __global__
function whose mangled name contains --match (default: every function), its
instruction count and each loop's: the instructions between a backward
branch and its target, by opcode. A loop body holding both sides of a
branch (an `if` on a launch-wide value) counts both, so read the opcodes
against the source. Needs nvcc and the CUDA toolkit's cuobjdump. The counts
are static: executed counts need a profiler such as `ncu`.
"""
from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
from pathlib import Path

_INS = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
_FN = re.compile(r"\s*Function : (\S+)")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).exists():
        raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")
    return found


def functions(sass: str):
    """{mangled name: [(offset, opcode, operands)]} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FN.match(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INS.match(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def loops(ins):
    """[(start, end, Counter of opcodes)] for each backward branch."""
    found = []
    for off, op, rest in ins:
        if op.startswith("BRA"):
            target = re.search(r"0x([0-9a-f]+)", rest)
            if target and int(target.group(1), 16) < off:
                start = int(target.group(1), 16)
                body = collections.Counter(o.split(".")[0] for a, o, _ in ins if start <= a <= off)
                found.append((start, off, body))
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("library", nargs="?", default="depthwise_conv")
    ap.add_argument("--match", default="", help="a substring of the mangled function names")
    args = ap.parse_args(argv)

    from quantnet_torch import _build

    _build.build([args.library])
    path = _build._library_path(args.library)
    sass = subprocess.run([_cuobjdump(), "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    for name, ins in functions(sass).items():
        if args.match not in name:
            continue
        print(f"{name}: {len(ins)} instructions")
        for start, end, body in loops(ins):
            top = ", ".join(f"{op} {n}" for op, n in body.most_common(12))
            print(f"  loop {start:#x}-{end:#x}: {sum(body.values())} instructions ({top})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
