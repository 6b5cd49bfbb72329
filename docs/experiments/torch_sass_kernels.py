#!/usr/bin/env python3
"""One kernel's SASS, built from an earlier tree's source and from the
checkout's, compared instantiation by instantiation: a change beside a
kernel (a new kernel in its file, a helper moved into an inlined function)
must leave its instantiations' code as it was.  On a machine with nvcc:

    git archive HEAD msda_tpu_torch | tar -x -C build/pr_parent
    python3 docs/experiments/torch_sass_kernels.py \\
        build/pr_parent/msda_tpu_torch/csrc/msda_fwd.cu \\
        msda_tpu_torch/csrc/msda_fwd.cu 15msda_fwd_kernel

The last argument picks the kernel's functions by a piece of their
mangled names (``15msda_fwd_kernel`` is K1's, which the prologue variant's
``23msda_fwd_queries_kernel`` does not contain; ``""`` picks every
function, to check that a change to a shared header left a whole file's
kernels as they were); a function is keyed by the mangled name from that
piece on, with the hash of the file that its anonymous namespace's name
carries taken out.  Each function of the earlier build must be in the
checkout's with the same instructions (their spacing aside).  Writes the
listings under ``build/sass/``; exits non-zero if one differs or is
missing.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

OUT = Path("build/sass")


def listing(source: str, tag: str) -> dict[str, str]:
    """``{mangled name: SASS}`` of every function of ``source``."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cubin = OUT / f"{tag}.cubin"
    subprocess.run([f"{cuda}/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-o", str(cubin), source], check=True)
    text = subprocess.run([f"{cuda}/bin/cuobjdump", "-sass", str(cubin)],
                          capture_output=True, text=True,
                          check=True).stdout
    (OUT / f"{tag}.sass").write_text(text)
    # the file's hash in the names of its anonymous namespace
    text = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                  "_GLOBAL__N_", text)
    # the listing's column widths follow the longest name: compare the
    # instructions, not their spacing
    text = re.sub(r"[ \t]+", " ", text)
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {n: "\n".join(body) for n, body in funcs.items()}


def main(old: str, new: str, marker: str) -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    pick = (lambda funcs: {n[n.index(marker):]: b for n, b in funcs.items()
                           if marker in n})
    before, after = pick(listing(old, "old")), pick(listing(new, "new"))
    if not before:
        print(f"no function of {old} contains {marker!r}")
        return 1
    status = 0
    for key, body in sorted(before.items()):
        lines = body.count("\n") + 1
        if key not in after:
            print(f"{key[:70]}: MISSING from the checkout's build")
            status = 1
        elif after[key] == body:
            print(f"{key[:70]}: SASS identical ({lines} lines)")
        else:
            print(f"{key[:70]}: SASS DIFFERS ({lines} lines before, "
                  f"{after[key].count(chr(10)) + 1} after); first lines "
                  "that differ:")
            pairs = [(a, b) for a, b in zip(body.splitlines(),
                                            after[key].splitlines())
                     if a != b]
            for a, b in pairs[:4]:
                print(f"  - {a.strip()[:120]}\n  + {b.strip()[:120]}")
            status = 1
    return status


if __name__ == "__main__":
    if len(sys.argv) != 4:
        raise SystemExit(__doc__)
    sys.exit(main(*sys.argv[1:]))
