"""Compare the machine code of this checkout's kernels with another
checkout's, function by function.

    python3 tools/sass_diff.py OTHER_ROOT [--match REGEX] [--diff N]

Builds both kernel libraries (each root's ``_kernels.build()``, in a
process of its own with that root first on ``sys.path``), disassembles
them with ``cuobjdump -sass`` and compares the SASS of every function
whose mangled name matches REGEX (default: all). A function's SASS is its
instructions with their offsets from the function's start, so two builds
that compile a kernel alike print the same text once runs of blanks are
collapsed (cuobjdump pads every line of a cubin to its longest
instruction) and the per-compile tag that nvcc gives an anonymous
namespace (``_GLOBAL__N__<8 hex>_``) is masked, in names and
instructions alike. ``--diff N`` prints the first N lines of a
unified diff (other → this) of each function that differs. Needs the
CUDA toolkit (nvcc, cuobjdump), no card. The last line of the output is
one JSON object: {"same": [...], "differ": [...], "only_this": [...],
"only_other": [...]}, names sorted.
"""

import argparse
import difflib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_")
_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from chainer_speech_recognition_tpu_torch import _kernels; "
          "print(_kernels.build())")


def library(root: str) -> str:
    """Build ``root``'s kernel library (cached by content) → its path."""
    out = subprocess.run([sys.executable, "-c", _BUILD, root], cwd=root,
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def functions(so: str) -> dict[str, str]:
    """``cuobjdump -sass`` of ``so`` → {mangled name: its SASS text}."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    text = _ANON.sub("_GLOBAL__N__00000000_", text)
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = ""
        elif name is not None and "/*" in line:
            out[name] += " ".join(line.split()) + "\n"
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--match", default="", help="regex on mangled names")
    ap.add_argument("--diff", type=int, default=0,
                    help="lines of each differing function's diff to print")
    a = ap.parse_args()
    this = functions(library(ROOT))
    other = functions(library(os.path.abspath(a.other)))
    pick = re.compile(a.match)
    this = {k: v for k, v in this.items() if pick.search(k)}
    other = {k: v for k, v in other.items() if pick.search(k)}
    both = sorted(set(this) & set(other))
    res = {"same": [k for k in both if this[k] == other[k]],
           "differ": [k for k in both if this[k] != other[k]],
           "only_this": sorted(set(this) - set(other)),
           "only_other": sorted(set(other) - set(this))}
    for key, names in res.items():
        print(f"[sass] {key}: {len(names)}")
        for n in names:
            print(f"  {n}")
            if key == "differ" and a.diff > 0:
                lines = difflib.unified_diff(
                    other[n].splitlines(), this[n].splitlines(), "other",
                    "this", n=1, lineterm="")
                for line in list(lines)[:a.diff]:
                    print(f"    {line}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
