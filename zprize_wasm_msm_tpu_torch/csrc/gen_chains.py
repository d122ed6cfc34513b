"""Writes csrc/chains.cuh: the PTX carry chains of the field core.

    python3 zprize_wasm_msm_tpu_torch/csrc/gen_chains.py

A carry chain (add.cc / addc, sub.cc / subc, mad.lo.cc / madc.hi.cc) must
sit inside ONE asm statement: the carry flag does not survive from one asm
statement to the next.  An asm string is a literal, so every chain is
written out once per field width the sources instantiate (NW = 2, 8, 12
and, for the elementwise field kernels, 24 words).  This script is the one
place those strings are made; the header it writes is committed, and
tests/test_torch_chains.py checks that the two agree and runs every chain
through a small PTX interpreter on random words.

GCC-style inline assembly takes at most 30 operands a statement.  Up to
NW = 12 a chain is one statement of at most 26 operands (13 + 12 + 1).
Wider chains are split into statements of at most SPLIT words each: a
statement ends by saving its carry in a register (addc.u32 c, 0, 0; over a
subtraction the borrow mask, subc.u32 c, 0, 0), and the next one sets the
carry flag again from it before its own chain (add.cc.u32 x, c, 0xffffffff
carries out iff c = 1; sub.cc.u32 x, 0, c borrows iff c != 0).  A
Montgomery step's m = t_0 np is then a statement of its own.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

WIDTHS = (2, 8, 12, 24)
#: words of one statement of a split chain (chains wider than this are split)
SPLIT = 12
HEADER = Path(__file__).resolve().parent / "chains.cuh"


def add_chain(nw):
    """s += b over nw words (%0..%nw-1 = s, then b); the carry out is
    dropped: callers guarantee the sum fits."""
    lines = []
    for i in range(nw):
        op = "add.cc" if i == 0 else ("addc" if i == nw - 1 else "addc.cc")
        lines.append(f"{op}.u32 %{i}, %{i}, %{nw + i};")
    return lines


def sub_chain(nw):
    """d -= b over nw words; %0 = mask out (0xffffffff on a borrow out),
    %1..%nw = d, then b."""
    lines = []
    for i in range(nw):
        op = "sub.cc" if i == 0 else "subc.cc"
        lines.append(f"{op}.u32 %{1 + i}, %{1 + i}, %{1 + nw + i};")
    lines.append("subc.u32 %0, 0, 0;")
    return lines


def mac_chain(nw):
    """t[0..nw] = t[0..nw-1] + a * b: %0..%nw = t, then a, then b.  Two
    chains: the low halves of a_j * b into t_j (carry into t_nw), then the
    high halves into t_{j+1}."""
    t = list(range(nw + 1))
    a = list(range(nw + 1, 2 * nw + 1))
    b = 2 * nw + 1
    lines = []
    for j in range(nw):
        op = "mad.lo.cc" if j == 0 else "madc.lo.cc"
        lines.append(f"{op}.u32 %{t[j]}, %{a[j]}, %{b}, %{t[j]};")
    lines.append(f"addc.u32 %{t[nw]}, 0, 0;")
    for j in range(nw):
        op = "mad.hi.cc" if j == 0 else ("madc.hi" if j == nw - 1 else "madc.hi.cc")
        lines.append(f"{op}.u32 %{t[j + 1]}, %{a[j]}, %{b}, %{t[j + 1]};")
    return lines


def reduce_chain(nw):
    """m = t_0 * np; t[0..nw] += m * q, which clears t_0: %0..%nw = t, then
    q, then np.  The carry out of t_nw is zero when q < 2^(32 nw - 1)."""
    t = list(range(nw + 1))
    q = list(range(nw + 1, 2 * nw + 1))
    np_ = 2 * nw + 1
    lines = [".reg .u32 m;", f"mul.lo.u32 m, %{t[0]}, %{np_};"]
    for j in range(nw):
        op = "mad.lo.cc" if j == 0 else "madc.lo.cc"
        lines.append(f"{op}.u32 %{t[j]}, m, %{q[j]}, %{t[j]};")
    lines.append(f"addc.u32 %{t[nw]}, %{t[nw]}, 0;")
    for j in range(nw):
        op = "mad.hi.cc" if j == 0 else ("madc.hi" if j == nw - 1 else "madc.hi.cc")
        lines.append(f"{op}.u32 %{t[j + 1]}, m, %{q[j]}, %{t[j + 1]};")
    return lines


CHAINS = {"add": add_chain, "sub": sub_chain, "mac": mac_chain, "reduce": reduce_chain}


def _ops(name, n, cons, lo=0):
    """Operands (constraint, C expression) name[lo .. lo+n-1]."""
    return [(cons, f"{name}[{lo + i}]") for i in range(n)]


def _carry_in(k):
    """Lines that set the carry flag from operand %k (0 or 1)."""
    return [".reg .u32 x;", f"add.cc.u32 x, %{k}, 0xffffffff;"]


def _split_add(nw):
    parts = []
    for lo in range(0, nw, SPLIT):
        n = min(SPLIT, nw - lo)
        first, last = lo == 0, lo + n == nw
        ops = _ops("s", n, "+r", lo) + _ops("b", n, "r", lo)
        lines = [] if first else _carry_in(2 * n)
        for i in range(n):
            op = "add.cc" if first and i == 0 else ("addc" if last and i == n - 1 else "addc.cc")
            lines.append(f"{op}.u32 %{i}, %{i}, %{n + i};")
        if not first:
            ops.append(("r", "c"))
        if not last:
            lines.append(f"addc.u32 %{len(ops)}, 0, 0;")
            ops.append(("=r", "c"))
        parts.append((lines, ops))
    return parts


def _split_sub(nw):
    parts = []
    for lo in range(0, nw, SPLIT):
        n = min(SPLIT, nw - lo)
        first = lo == 0
        ops = [("=r", "mask")] + _ops("d", n, "+r", lo) + _ops("b", n, "r", lo)
        lines = [] if first else [".reg .u32 x;", f"sub.cc.u32 x, 0, %{1 + 2 * n};"]
        for i in range(n):
            op = "sub.cc" if first and i == 0 else "subc.cc"
            lines.append(f"{op}.u32 %{1 + i}, %{1 + i}, %{1 + n + i};")
        lines.append("subc.u32 %0, 0, 0;")
        if not first:
            ops.append(("r", "mask"))
        parts.append((lines, ops))
    return parts


def _split_rows(nw, a, b, top_op):
    """The two chains of mac (a = "a", b = "b") and reduce (a = "q", b = "m")
    in statements of SPLIT words: t[0..nw-1] += lo(a_j b), carry into t[nw]
    (``top_op``: addc.u32 t_nw, 0, 0 for mac, t_nw, t_nw, 0 for reduce);
    then t[1..nw] += hi(a_j b)."""
    parts = []
    for half in ("lo", "hi"):
        for lo in range(0, nw, SPLIT):
            n = min(SPLIT, nw - lo)
            first, last = lo == 0, lo + n == nw
            shift = 0 if half == "lo" else 1
            ops = _ops("t", n, "+r", lo + shift)
            if half == "lo" and last:
                ops.append(("+r", f"t[{nw}]"))
            ops += _ops(a, n, "r", lo) + [("r", b)]
            k_a, k_b = len(ops) - n - 1, len(ops) - 1
            lines = []
            if not first:
                lines += _carry_in(len(ops))
                ops.append(("r", "c"))
            for i in range(n):
                cc = not (half == "hi" and last and i == n - 1)
                op = ("mad" if first and i == 0 else "madc") + f".{half}" + (".cc" if cc else "")
                lines.append(f"{op}.u32 %{i}, %{k_a + i}, %{k_b}, %{i};")
            if half == "lo" and last:
                lines.append(f"{top_op.format(t=n)};")
            elif not last:
                lines.append(f"addc.u32 %{len(ops)}, 0, 0;")
                ops.append(("=r", "c"))
            parts.append((lines, ops))
    return parts


def _outputs_first(part):
    """GCC numbers a statement's operands outputs first: reorder the
    operands so, and renumber the lines' %k to match."""
    lines, ops = part
    order = [k for k, (c, _) in enumerate(ops) if c[0] in "+="]
    order += [k for k, (c, _) in enumerate(ops) if c[0] not in "+="]
    new = {old: k for k, old in enumerate(order)}
    lines = [re.sub(r"%(\d+)", lambda mt: f"%{new[int(mt.group(1))]}", l) for l in lines]
    return lines, [ops[k] for k in order]


def parts(name, nw):
    """The asm statements of one chain at width nw: [(lines, operands)],
    operands as (constraint, C expression).  One statement up to SPLIT
    words; wider chains in statements of SPLIT words, the carry between
    them in the C variable c (mask for sub), reduce's m = t_0 np first."""
    if nw <= SPLIT:
        ops = {
            "add": _ops("s", nw, "+r") + _ops("b", nw, "r"),
            "sub": [("=r", "mask")] + _ops("d", nw, "+r") + _ops("b", nw, "r"),
            "mac": _ops("t", nw + 1, "+r") + _ops("a", nw, "r") + [("r", "b")],
            "reduce": _ops("t", nw + 1, "+r") + _ops("q", nw, "r") + [("r", "np")],
        }[name]
        return [(CHAINS[name](nw), ops)]
    if name == "add":
        split = _split_add(nw)
    elif name == "sub":
        split = _split_sub(nw)
    elif name == "mac":
        split = _split_rows(nw, "a", "b", "addc.u32 %{t}, 0, 0")
    else:
        m = (["mul.lo.u32 %0, %1, %2;"], [("=r", "m"), ("r", "t[0]"), ("r", "np")])
        split = [m] + _split_rows(nw, "q", "m", "addc.u32 %{t}, %{t}, 0")
    return [_outputs_first(p) for p in split]


def _asm(lines, ops, indent="    "):
    body = "\n".join(f'{indent}    "{l}\\n\\t"' for l in lines)
    outs = ", ".join(f'"{c}"({e})' for c, e in ops if c[0] in "+=")
    ins = ", ".join(f'"{c}"({e})' for c, e in ops if c[0] not in "+=")
    return (
        f"{indent}asm volatile(\n{indent}    \"{{\\n\\t\"\n{body}\n{indent}    \"}}\"\n"
        f"{indent}    : {outs}\n{indent}    : {ins});"
    )


def _body(name, nw):
    """The C++ body of one chain: its statements, and the carry's variable
    where the chain is split."""
    ps = parts(name, nw)
    decl = []
    if len(ps) > 1:
        decl = ["    uint32_t c;"] if name in ("add", "mac") else (
            ["    uint32_t c, m;"] if name == "reduce" else [])
    return "\n".join(decl + [_asm(lines, ops) for lines, ops in ps])


def specialization(nw):
    return f"""template <>
struct Chains<{nw}> {{
  // s += b
  static __device__ __forceinline__ void add(uint32_t (&s)[{nw}], const uint32_t (&b)[{nw}]) {{
{_body("add", nw)}
  }}
  // d -= b; returns 0xffffffff on a borrow out, else 0
  static __device__ __forceinline__ uint32_t sub(uint32_t (&d)[{nw}], const uint32_t (&b)[{nw}]) {{
    uint32_t mask;
{_body("sub", nw)}
    return mask;
  }}
  // t[0..{nw}] = t[0..{nw - 1}] + a * b
  static __device__ __forceinline__ void mac(uint32_t (&t)[{nw + 1}], const uint32_t (&a)[{nw}],
                                             uint32_t b) {{
{_body("mac", nw)}
  }}
  // t[0..{nw}] += (t[0] * np mod 2^32) * q: t[0] becomes 0
  static __device__ __forceinline__ void reduce(uint32_t (&t)[{nw + 1}], const uint32_t (&q)[{nw}],
                                                uint32_t np) {{
{_body("reduce", nw)}
  }}
}};
"""


def render():
    parts = [
        "// GENERATED by gen_chains.py (same directory); edit that script, not this file.",
        "//",
        "// PTX carry chains of the field core (field.cuh), one specialization per",
        "// field width.  Every chain is ONE asm statement: the carry flag does not",
        "// survive from one asm statement to the next.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "template <int NW>",
        "struct Chains;",
        "",
    ]
    for nw in WIDTHS:
        parts.append(specialization(nw))
    return "\n".join(parts)


if __name__ == "__main__":
    HEADER.write_text(render())
    sys.stdout.write(f"wrote {HEADER}\n")
