"""What the kernels compiled to: the SASS of the built library, read with
`cuobjdump -sass` from the CUDA toolkit (on the machine with the card).

`functions` splits a listing into its kernels' instructions with their
addresses; `inner_loops` finds the innermost loops, each the span from a
backward branch's target to the branch; `load_counts` counts the loads of
a stretch by where they read: `LDS` (shared memory, one load a thread),
`LDC` (the constant bank through the constant cache), `ULDC` (the constant
bank into a uniform register: one load a warp, on the uniform datapath),
the constant-bank operands that other instructions take directly
(`c[0x0][0x...]`) and `LDG` (device memory).
"""

from __future__ import annotations

import os
import re
import subprocess

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\bBRA(?:\.\S+)?\s+(0x[0-9a-f]+)")
# a Philox round's multipliers (csrc/tracer.cu `philox`) as ptxas may print
# them: unsigned, or as the negative int32 of the same bits
_PHILOX = ("0xd2511f53", "-0x2daee0ad", "0xcd9e8d57", "-0x326172a9")


def cuobjdump_sass(library: str) -> str:
    """`cuobjdump -sass` of a built library."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                       "cuobjdump")
    return subprocess.run([exe, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def functions(text: str) -> dict:
    """A SASS listing → {mangled kernel name: [(address, instruction)]},
    each instruction with its predicate and without its encoding or `;`; a
    branch to a label (`` `(.L_x_N) ``, as newer toolkits print them) is
    written with the address of the label's instruction."""
    funcs, labels, name, pending = {}, {}, None, []
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            name, pending = m.group(1), []
            funcs[name], labels[name] = [], {}
        elif name is not None and _LABEL.match(line):
            pending.append(_LABEL.match(line).group(1))
        elif name is not None and _INSTR.match(line):
            m = _INSTR.match(line)
            addr = int(m.group(1), 16)
            labels[name].update((lab, addr) for lab in pending)
            pending = []
            funcs[name].append((addr, m.group(2)))
    return {n: [(a, re.sub(r"`\((\.L_x_\d+)\)",
                           lambda b: hex(labels[n].get(b.group(1), 1 << 62)),
                           s)) for a, s in ins]
            for n, ins in funcs.items()}


def opcode(instr: str) -> str:
    """The opcode of an instruction, past its predicate."""
    words = instr.split()
    return words[1] if words[0].startswith("@") else words[0]


def inner_loops(instrs: list) -> list:
    """The innermost loops of one function, in address order: (first
    address, address of the backward branch) of each loop that holds no
    other."""
    spans = set()
    for addr, s in instrs:
        m = _TARGET.search(s)
        if m and int(m.group(1), 16) <= addr:
            spans.add((int(m.group(1), 16), addr))
    return sorted(a for a in spans
                  if not any(b != a and a[0] <= b[0] and b[1] <= a[1]
                             for b in spans))


def load_counts(instrs: list) -> dict:
    """The loads of a stretch of SASS (instructions), by where they read."""
    ops = [opcode(s) for s in instrs]
    return dict(
        instructions=len(instrs),
        lds=sum(o.startswith("LDS") for o in ops),
        ldc=sum(o.startswith("LDC") for o in ops),
        uldc=sum(o.startswith("ULDC") for o in ops),
        const_operands=sum("c[0x" in s for o, s in zip(ops, instrs)
                           if not o.startswith(("LDC", "ULDC"))),
        ldg=sum(o.startswith("LDG") for o in ops))


def row_loops(instrs: list) -> list:
    """The loads of each innermost loop of a K1 instantiation that tests
    rows of the unrolled record, in address order, with its first and last
    address: a loop with a square root (the sphere test's `MUFU.RSQ`) and
    with no Philox draw (the media race), no sine or cosine (the marble's
    lattice corners) and no device-memory load (the staging loops, the
    tables' members)."""
    out = []
    for lo, hi in inner_loops(instrs):
        body = [s for a, s in instrs if lo <= a <= hi]
        ops = [opcode(s) for s in body]
        text = "\n".join(body).lower()
        if ("MUFU.RSQ" in ops
                and not any(c in text for c in _PHILOX)
                and not any(o in ("MUFU.SIN", "MUFU.COS")
                            or o.startswith("LDG") for o in ops)):
            out.append(dict(first=hex(lo), last=hex(hi), **load_counts(body)))
    return out
