"""Count the machine instructions of a kernel's loops from ``cuobjdump -sass``.

    cuobjdump -sass libebm_kernels_<hash>.so > sass.txt
    python -m energybalancemodel_jl_tpu_torch.tools.sass_count sass.txt \\
        --function 'miz_year_kernelIfLi192ELi5ELb0ELb0E'

For every function whose (mangled) name holds ``--function`` it prints the
loops it finds, nested: a loop is the address range of a backward branch.
Per loop: the instructions of its own body (inner loops excluded) and of the
whole range, its barriers, and the own body by class (memory, shared memory,
special-function unit, floating point, integer and the rest, control). The
instructions one pass of an outer loop issues are its own body plus each
inner loop's body times that loop's trip count, which the reader supplies:
the counts are static, per warp. ``.gz`` files are read as they are.
"""
from __future__ import annotations

import argparse
import gzip
import re
import sys
from collections import Counter

CLASSES = (
    ("barrier", ("BAR",)),
    ("shared", ("LDS", "STS", "LDSM")),
    ("memory", ("LDG", "STG", "LD", "ST", "LDL", "STL", "LDC", "ATOM", "RED")),
    ("shuffle", ("SHFL",)),
    ("special", ("MUFU",)),
    ("float", ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "FCHK", "DADD", "DMUL",
               "DFMA", "DSETP", "F2F", "I2F", "F2I", "I2FP", "FSET")),
    ("control", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC", "BREAK", "JMP")),
)


def classify(op):
    base = op.split(".")[0]
    for name, ops in CLASSES:
        if base in ops:
            return name
    return "integer/other"


def functions(text):
    """name -> [(address, predicate+opcode text, branch target or None)]."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name:
            addr, body = int(m.group(1), 16), m.group(2).strip()
            words = body.split()
            op = words[1] if words and words[0].startswith("@") and len(words) > 1 else words[0]
            target = None
            t = re.search(r"\b(?:BRA|JMP)\b.*?(0x[0-9a-f]+)", body)
            if t:
                target = int(t.group(1), 16)
            out[name].append((addr, op, target))
    return out


def loops(instrs):
    """[(start, end)] of backward branches, outermost first."""
    found = sorted({(t, a) for a, _, t in instrs if t is not None and t <= a},
                   key=lambda r: (r[0], -r[1]))
    return found


def report(name, instrs):
    print(f"{name}: {len(instrs)} instructions, "
          f"{sum(1 for _, op, _ in instrs if op.startswith('BAR'))} barriers")
    ranges = loops(instrs)
    for k, (start, end) in enumerate(ranges):
        depth = sum(1 for s, e in ranges if s <= start and end <= e and (s, e) != (start, end))
        inner = [(s, e) for s, e in ranges if start <= s and e <= end and (s, e) != (start, end)]
        whole = [(a, op) for a, op, _ in instrs if start <= a <= end]
        own = [(a, op) for a, op in whole if not any(s <= a <= e for s, e in inner)]
        hist = Counter(classify(op) for _, op in own)
        print(f"{'  ' * (depth + 1)}loop {k} [{start:#06x}, {end:#06x}]: own body {len(own)}, "
              f"whole range {len(whole)}, barriers in own body {hist.get('barrier', 0)}; "
              + ", ".join(f"{c} {n}" for c, n in sorted(hist.items())))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sass")
    ap.add_argument("--function", required=True, help="part of the mangled kernel name")
    args = ap.parse_args(argv)
    opener = gzip.open if args.sass.endswith(".gz") else open
    with opener(args.sass, "rt") as fh:
        text = fh.read()
    hits = {n: i for n, i in functions(text).items() if args.function in n}
    if not hits:
        raise SystemExit(f"no function holds {args.function!r}")
    for name, instrs in hits.items():
        report(name, instrs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
