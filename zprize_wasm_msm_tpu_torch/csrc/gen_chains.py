"""Writes csrc/chains.cuh: the PTX carry chains of the field core.

    python3 zprize_wasm_msm_tpu_torch/csrc/gen_chains.py

A carry chain (add.cc / addc, sub.cc / subc, mad.lo.cc / madc.hi.cc) must
sit inside ONE asm statement: the carry flag does not survive from one asm
statement to the next.  An asm string is a literal, so every chain is
written out once per field width the sources instantiate (NW = 2, 8, 12
words).  This script is the one place those strings are made; the header
it writes is committed, and tests/test_torch_chains.py checks that the two
agree and runs every chain through a small PTX interpreter on random words.

Each chain keeps to at most 26 asm operands (the widest, NW = 12, is
13 + 12 + 1): below the 30 that GCC-style inline assembly allows.
"""

from __future__ import annotations

import sys
from pathlib import Path

WIDTHS = (2, 8, 12)
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


def _asm(lines, outs, ins, indent="    "):
    body = "\n".join(f'{indent}    "{l}\\n\\t"' for l in lines)
    return (
        f"{indent}asm volatile(\n{indent}    \"{{\\n\\t\"\n{body}\n{indent}    \"}}\"\n"
        f"{indent}    : {', '.join(outs)}\n{indent}    : {', '.join(ins)});"
    )


def _words(name, n, cons):
    return [f'"{cons}"({name}[{i}])' for i in range(n)]


def specialization(nw):
    return f"""template <>
struct Chains<{nw}> {{
  // s += b
  static __device__ __forceinline__ void add(uint32_t (&s)[{nw}], const uint32_t (&b)[{nw}]) {{
{_asm(add_chain(nw), _words("s", nw, "+r"), _words("b", nw, "r"))}
  }}
  // d -= b; returns 0xffffffff on a borrow out, else 0
  static __device__ __forceinline__ uint32_t sub(uint32_t (&d)[{nw}], const uint32_t (&b)[{nw}]) {{
    uint32_t mask;
{_asm(sub_chain(nw), ['"=r"(mask)'] + _words("d", nw, "+r"), _words("b", nw, "r"))}
    return mask;
  }}
  // t[0..{nw}] = t[0..{nw - 1}] + a * b
  static __device__ __forceinline__ void mac(uint32_t (&t)[{nw + 1}], const uint32_t (&a)[{nw}],
                                             uint32_t b) {{
{_asm(mac_chain(nw), _words("t", nw + 1, "+r"), _words("a", nw, "r") + ['"r"(b)'])}
  }}
  // t[0..{nw}] += (t[0] * np mod 2^32) * q: t[0] becomes 0
  static __device__ __forceinline__ void reduce(uint32_t (&t)[{nw + 1}], const uint32_t (&q)[{nw}],
                                                uint32_t np) {{
{_asm(reduce_chain(nw), _words("t", nw + 1, "+r"), _words("q", nw, "r") + ['"r"(np)'])}
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
