"""PyTorch port, field core carry chains: the PTX of csrc/chains.cuh run on
the CPU.

csrc/field.cuh builds its carries from PTX carry chains that
csrc/gen_chains.py writes into csrc/chains.cuh.  The CPU test run has no
CUDA compiler, so the chains' text itself is checked here: a small PTX
interpreter (add.cc / addc, sub.cc / subc, mad.lo.cc / madc.hi.cc with one
carry flag) runs them, wrapped the way field.cuh wraps them (add with one
conditional subtract, sub with q added back on a borrow, neg, the no-carry
CIOS product fe_mul_cc), on the same numpy inputs as the JAX package's
ops.field.mont; fe_mul, the same product in 64-bit C rows, runs here in
Python integers with its no-carry bound asserted.
Results must be equal bit for bit (integers, tolerance zero).  The same
functions run compiled on the card in chip_smoke.py's device-function phase.
"""

import importlib.util

import numpy as np
import pytest

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.field import mont as ref_mont
from zprize_wasm_msm_tpu_torch import _build
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.ops.field.spec import FieldSpec
from zprize_wasm_msm_tpu_torch.utils.limbs import limbs_to_ints

from tests._torch_helpers import field_operands, mont_limbs, to_jax

_spec = importlib.util.spec_from_file_location("gen_chains", _build.CSRC / "gen_chains.py")
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

M32 = (1 << 32) - 1
NAMES = ["toy", "bn254", "bls12_381", "mnt6753"]


def run_ptx(lines, regs):
    """Interpret one chain: regs[i] is operand %i; returns the new regs."""
    regs = list(regs)
    cf = 0

    local = {}  # registers the chain declares itself (.reg)

    def val(tok):
        if tok.startswith("%"):
            return regs[int(tok[1:])]
        return local[tok] if tok in local else int(tok, 0)

    def put(tok, v):
        if tok.startswith("%"):
            regs[int(tok[1:])] = v & M32
        else:
            local[tok] = v & M32

    for line in lines:
        if line.startswith(".reg"):
            continue
        op, args = line.rstrip(";").split(None, 1)
        ops = [a.strip() for a in args.split(",")]
        parts = op.split(".")
        base, cc = parts[0], "cc" in parts
        assert parts[-1] == "u32", line
        if base in ("add", "addc"):
            s = val(ops[1]) + val(ops[2]) + (cf if base == "addc" else 0)
            put(ops[0], s)
            if cc:
                cf = s >> 32
        elif base in ("sub", "subc"):
            d = val(ops[1]) - val(ops[2]) - (cf if base == "subc" else 0)
            put(ops[0], d)
            if cc:
                cf = int(d < 0)
        elif base in ("mad", "madc"):
            p = val(ops[1]) * val(ops[2])
            half = p & M32 if parts[1] == "lo" else p >> 32
            s = half + val(ops[3]) + (cf if base == "madc" else 0)
            put(ops[0], s)
            if cc:
                cf = s >> 32
        elif base == "mul":
            assert parts[1] == "lo", line
            put(ops[0], val(ops[1]) * val(ops[2]))
        else:
            raise AssertionError(f"unknown instruction {line}")
    return regs


def run_chain(name, nw, env):
    """Run the asm statements of one chain (gen.parts: one statement up to
    SPLIT words, several above, their carry in a C variable) on ``env``, a
    dict from the operands' C expressions to words; returns env updated."""
    for lines, ops in gen.parts(name, nw):
        regs = run_ptx(lines, [env.get(expr, 0) for _, expr in ops])
        for (cons, expr), v in zip(ops, regs):
            if cons[0] in "+=":
                env[expr] = v
    return env


def _env(**arrays):
    return {f"{k}[{i}]": v for k, vals in arrays.items() for i, v in enumerate(vals)}


def chain_add(nw, s, b):
    env = run_chain("add", nw, _env(s=s, b=b))
    return [env[f"s[{i}]"] for i in range(nw)]


def chain_sub(nw, d, b):
    env = run_chain("sub", nw, _env(d=d, b=b))
    return [env[f"d[{i}]"] for i in range(nw)], env["mask"]


def chain_mac(nw, t, a, b):
    env = run_chain("mac", nw, {**_env(t=t, a=a), "b": b})
    return [env[f"t[{i}]"] for i in range(nw + 1)]


def chain_reduce(nw, t, q, np32):
    env = run_chain("reduce", nw, {**_env(t=t, q=q), "np": np32})
    return [env[f"t[{i}]"] for i in range(nw + 1)]


class Core:
    """field.cuh's fe_* on the interpreted chains."""

    def __init__(self, fq):
        self.nw = fq.n_words
        self.q = [int(w) for w in fq.q_words]
        self.np32 = int(fq.np32)

    def reduce_once(self, s):
        d, borrow = chain_sub(self.nw, s, self.q)
        return s if borrow else d

    def add(self, a, b):
        return self.reduce_once(chain_add(self.nw, a, b))

    def sub(self, a, b):
        d, borrow = chain_sub(self.nw, a, b)
        return chain_add(self.nw, d, [w & borrow for w in self.q])

    def neg(self, a):
        d, _ = chain_sub(self.nw, self.q, a)
        return [0] * self.nw if not any(a) else d

    def mul(self, a, b):
        """fe_mul's no-carry CIOS rows (64-bit C there): the row's top word
        must absorb every carry, which is what the free top bit of q buys."""
        nw = self.nw
        t = [0] * (nw + 1)
        for i in range(nw):
            c = 0
            for j in range(nw):
                s = a[j] * b[i] + t[j] + c
                t[j], c = s & M32, s >> 32
            t[nw] = c
            m = (t[0] * self.np32) & M32
            s = m * self.q[0] + t[0]
            assert s & M32 == 0
            c = s >> 32
            for j in range(1, nw):
                s = m * self.q[j] + t[j] + c
                t[j - 1], c = s & M32, s >> 32
            assert t[nw] + c <= M32  # no carry out of the row
            t[nw - 1] = t[nw] + c
        return self.reduce_once(t[:nw])

    def mul_cc(self, a, b):
        """fe_mul_cc: the same rows as PTX carry chains."""
        nw = self.nw
        t = [0] * (nw + 1)
        for i in range(nw):
            t = chain_mac(nw, t, a, b[i])
            t = chain_reduce(nw, t, self.q, self.np32)
            assert t[0] == 0
            t = t[1:] + [0]
        return self.reduce_once(t[:nw])


def words(x, nw):
    return [(x >> (32 * i)) & M32 for i in range(nw)]


def from_words(w):
    return sum(v << (32 * i) for i, v in enumerate(w))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("op", ["mul", "mul_cc", "add", "sub", "neg"])
def test_chains_match_reference_field_ops(name, op):
    ref, port = getattr(ref_curves, name), getattr(port_curves, name)
    a, b = field_operands(ref.q, 12, seed=31)
    la, lb = mont_limbs(ref.fq, a), mont_limbs(ref.fq, b)
    ref_fn = {"mul": ref_mont.mont_mul, "mul_cc": ref_mont.mont_mul, "add": ref_mont.add,
              "sub": ref_mont.sub}.get(op)
    want = (
        ref_mont.neg(ref.fq, to_jax(la)) if op == "neg" else ref_fn(ref.fq, to_jax(la), to_jax(lb))
    )
    want = limbs_to_ints(np.asarray(want))
    core = Core(port.fq)
    nw = port.fq.n_words
    for x, y, w in zip(limbs_to_ints(la), limbs_to_ints(lb), want):
        fn = getattr(core, op)
        got = fn(words(x, nw)) if op == "neg" else fn(words(x, nw), words(y, nw))
        assert from_words(got) == w, (name, op, x, y)


def test_header_is_the_generators_output():
    assert gen.HEADER.read_text() == gen.render()
    assert gen.WIDTHS == _build.FIELD_KERNEL_WORDS
    assert set(_build.SUPPORTED_WORDS) <= set(gen.WIDTHS)


@pytest.mark.parametrize("nw", gen.WIDTHS)
def test_chains_stay_within_asm_operand_limit(nw):
    """GCC-style inline assembly takes at most 30 operands per statement;
    every operand of a statement is used, outputs numbered first (as GCC
    numbers them), and a chain is split only above SPLIT words."""
    for name in gen.CHAINS:
        statements = gen.parts(name, nw)
        assert (len(statements) == 1) == (nw <= gen.SPLIT), (name, nw)
        for lines, ops in statements:
            used = {int(tok[1:].rstrip(";,")) for line in lines for tok in line.split() if tok.startswith("%")}
            assert len(ops) <= 30 and used == set(range(len(ops))), (name, nw)
            kinds = [cons[0] in "+=" for cons, _ in ops]
            assert kinds == sorted(kinds, reverse=True), (name, nw)


def test_field_consts_refuse_a_modulus_without_a_free_top_bit():
    q = (1 << 63) - 25  # prime, top word 0x7fffffff: the no-carry product's bound fails
    with pytest.raises(NotImplementedError, match="top bit"):
        _build.field_consts(FieldSpec(q=q))
    with pytest.raises(NotImplementedError, match="top bit"):
        _build.field_kernel_consts(FieldSpec(q=q))
    for name in NAMES:  # every field the kernels cover qualifies
        fq = getattr(port_curves, name).fq
        nw = fq.n_words
        assert _build.field_kernel_consts(fq)[nw - 1] < _build.TOP_WORD_LIMIT
        if nw in _build.SUPPORTED_WORDS:
            assert _build.field_consts(fq)[nw - 1] < _build.TOP_WORD_LIMIT
