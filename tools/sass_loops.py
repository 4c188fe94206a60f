#!/usr/bin/env python3
"""Instruction counts of the loops in the port's compiled CUDA kernels.

The card's machine has no ``ncu``, but what a kernel's loops issue can be
read from its compiled code. This builds the named kernels' libraries
(``gsplat_tpu_torch/kernels/build.py``), disassembles them with the
toolkit's ``cuobjdump -sass``, and for each entry function whose name holds
``--match`` prints one JSON line: each loop (the instructions from a
backward branch's target to the branch), its instruction count, the
instructions that forward branches inside it can skip (``skippable``: those
strictly between a predicated forward branch and its target), and its
opcodes by count. A loop that runs with every such branch taken issues
``instructions - skippable``::

    python3 tools/sass_loops.py probe_orientation --match orientation
    python3 tools/sass_loops.py raster_fwd --match raster_fwd_kernel

Needs ``nvcc`` and ``cuobjdump`` (the card's machine has both, under
``/usr/local/cuda/bin``); no card. This script imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gsplat_tpu_torch.kernels import build  # noqa: E402

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);")
_BRANCH = re.compile(r"^(@!?U?P\w+\s+)?BRA(?:\.\w+)*\s+(0x[0-9a-f]+)")


def functions(sass: str) -> dict:
    """Each entry function's instructions, ``[(address, text)]``, from a
    ``cuobjdump -sass`` listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSTRUCTION.search(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def _opcode(text: str) -> str:
    words = text.split()
    return (words[1] if words[0].startswith("@") else words[0]).split(".")[0]


def loops(instructions) -> list:
    """The loops of one function: for each backward branch, the instructions
    from its target to it, with the count forward branches inside can skip."""
    out = []
    for addr, text in instructions:
        m = _BRANCH.match(text)
        if not m or int(m.group(2), 16) >= addr:
            continue
        head = int(m.group(2), 16)
        body = [(a, t) for a, t in instructions if head <= a <= addr]
        skippable = set()
        for a, t in body:
            fm = _BRANCH.match(t)
            if fm and fm.group(1) and addr >= int(fm.group(2), 16) > a:
                skippable.update(b for b, _ in body if a < b < int(fm.group(2), 16))
        out.append({"head": hex(head), "branch": hex(addr), "instructions": len(body), "skippable": len(skippable),
                    "opcodes": dict(collections.Counter(_opcode(t) for _, t in body).most_common())})
    return out


def cuobjdump_path() -> str:
    return os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="+", choices=sorted(build.SOURCES), help="kernel libraries (build.SOURCES)")
    ap.add_argument("--match", default="", help="only entry functions whose name holds this")
    args = ap.parse_args(argv)
    build.build(args.kernels)
    for kernel in args.kernels:
        sass = subprocess.run([cuobjdump_path(), "-sass", str(build.library_path(kernel))], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        for name, instructions in functions(sass).items():
            if args.match in name:
                print(json.dumps({"kernel": kernel, "function": name, "instructions": len(instructions),
                                  "loops": loops(instructions)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
