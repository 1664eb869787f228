"""K1: each expression stage of a program as one generated CUDA kernel.

Replaces ``ydb_tpu/ops/xla_exec.py:75 _eval`` over ``ops/kernels.py
KERNELS`` (40 ops), which the reference's ``_trace_program`` runs for
every Assign and Filter and XLA fuses into the query's one program.
torch runs eagerly, so the plain version (``torch_exec._eval``) launches
one torch kernel per operator and per validity combination: q19's
expressions take some 300 launches.

A **stage** is a maximal run of consecutive ``ir.Assign`` / ``ir.Filter``
commands, as ``torch_exec._trace_program`` walks a program (the
``rank_assigns`` of the fused and portioned finals form one stage each).
Its inputs are the env columns it reads (data, and validity where
present), its params and the incoming selection mask; its outputs are
every Assign's (data, valid) and the new mask. The generator turns a
stage plus its input signature — each input's dtype, validity presence
and member-ness, each param's kind and dtype, the mask's presence —
into CUDA C++ for ONE kernel: one thread per row reads each input once,
evaluates the whole stage in registers and writes each output once.

**K1 ×B** (the batched serving lane) also replaces the member axis that
``ydb_tpu/ops/fused.py:299 build_fused_batched_fn`` gives ``_eval`` (its
``jax.vmap``, ``:322``). A stage over B members is one launch on a 1-D
grid: the generator knows which values read the member index ``m`` (a
per-member column, a ``PerMember`` (B,) scalar read once a member, a
(B, L) LUT read at ``m * L``, a per-member incoming mask, or a value
computed from one) and emits every other line once, before
``for (m = 0; m < members; ++m)``, which holds only the per-member
lines and stores. So each shared column is loaded, and each expression
of shared values evaluated, once a row for all B members, and a shared
output is stored once; ``members`` is a kernel argument (1 for a stage
with no per-member output). A value of the member alone (its (B,)
params and their conversions) is computed once a block for every
member (``k1_members``, into shared memory) and read back in the loop.

Each output matches the plain version exactly in storage dtype, in
whether its validity is ``None`` and in shape ((cap,) or (B, cap)): the
emitters below derive all three by the rules ``_eval`` and
``torch_ns.TXP`` apply (torch's type promotion, its default float for
int → float math, `where`'s broadcasting), and the values bit for bit
(the helpers of ``cuda/csrc/k1_prelude.cuh``: wrapping ints, floor
division, civil dates, hashing, Kleene logic; compiled with
``--fmad=false``, as torch rounds ``a*b`` and ``+c`` separately).

A composite hash key, ``hash_combine(hash64(c0), ...)``, keeps its K12
route (``torch_exec._eval_hashed_key``, one ``hash64`` launch) and
enters the stage as an input column.

A Filter keeps the rows whose predicate is TRUE, and through ``and`` /
``or`` that is two-valued (an AND is TRUE iff every operand is, an OR
iff one is): a filter's connectives carry no validity (``_Gen.truth``),
the same mask as the plain version's data & valid.

Bound on the H100: bytes. A stage does a few operations per row on
8-byte values, far below the card's integer and float rates; its floor
is the columns it reads once and the outputs it writes once (at B
members: the shared inputs once, the per-member ones and the outputs B
times). Design: one launch per stage instead of one per operator and
intermediate, no intermediate in device memory, coalesced loads and
stores; over members, the shared loads and work once a row (a grid row
a member read every shared column B times: q19's member stage took
0.59 ms where its bytes need 0.056). Past the loads, a member's work is
instructions: the Kleene pairs of q19's filter cost 67 instructions a
member, the two-valued filter a third of that (0.21 → 0.10 ms at B =
8).

Routing (``run_stage``): CUDA tensors launch the generated kernel (built
by NVRTC on first use, ``ops/cuda/nvrtc.py``) or raise; CPU tensors run
the plain version. Nothing falls back to torch on the card.
"""

from __future__ import annotations

import ctypes
import re
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ydb_tpu_torch.core.dtypes import DType, Kind
from ydb_tpu_torch.ops import ir
from ydb_tpu_torch.ops.torch_ns import torch_dtype

PRELUDE_PATH = (Path(__file__).resolve().parent / "cuda" / "csrc"
                / "k1_prelude.cuh")
ENTRY = "k1_stage"                 # the __global__ function of every stage
THREADS = 256

_C = {torch.bool: "k1_b", torch.int8: "k1_i8", torch.int16: "k1_i16",
      torch.int32: "k1_i32", torch.int64: "k1_i64", torch.uint8: "k1_u8",
      torch.float32: "k1_f32", torch.float64: "k1_f64"}
_CT = {torch.bool: ctypes.c_bool, torch.int8: ctypes.c_int8,
       torch.int16: ctypes.c_int16, torch.int32: ctypes.c_int32,
       torch.int64: ctypes.c_int64, torch.uint8: ctypes.c_uint8,
       torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
_INTS = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)
_FLOATS = (torch.float32, torch.float64)


class Unsupported(TypeError):
    """An op over operand dtypes the generator does not emit (the plain
    version rejects most of them too). Raised, never run in torch."""


def _prelude() -> str:
    global _PRELUDE
    if _PRELUDE is None:
        _PRELUDE = PRELUDE_PATH.read_text()
    return _PRELUDE


_PRELUDE: Optional[str] = None


# --------------------------------------------------------------------------
# signatures
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ColSig:
    """An input column: storage dtype, member axis on the data, validity
    presence and member axis on the validity."""
    dtype: torch.dtype
    pm: bool
    valid: bool
    valid_pm: bool


@dataclass(frozen=True)
class ParamSig:
    """A param: `kind` scalar (a host value, passed by value), dscalar (a
    0-d tensor), array (an (L,) LUT), pm_scalar ((B,) `PerMember`) or
    pm_array ((B, L) `PerMember`); `dtype` is the value's storage dtype
    (the Param node's for a host scalar, the tensor's otherwise)."""
    kind: str
    dtype: torch.dtype


def _col_sig(pair) -> ColSig:
    d, v = pair
    return ColSig(d.dtype, d.dim() == 2, v is not None,
                  v is not None and v.dim() == 2)


def _param_sig(p: ir.Param, val) -> ParamSig:
    from ydb_tpu_torch.ops.torch_exec import PerMember
    if isinstance(val, PerMember):
        return ParamSig("pm_array" if p.is_array else "pm_scalar",
                        val.t.dtype)
    if isinstance(val, torch.Tensor):
        if p.is_array:
            return ParamSig("array", val.dtype)
        return ParamSig("dscalar", val.dtype)
    if p.is_array:
        raise TypeError(f"array param {p.name}: {type(val).__name__}, "
                        "expected a tensor")
    return ParamSig("scalar", torch_dtype(p.dtype.np))


# --------------------------------------------------------------------------
# the generator
# --------------------------------------------------------------------------


@dataclass
class V:
    """A node's value in the row function: storage dtype, the C variable
    (or literal) of its data, of its validity (None: all valid), and
    whether each carries the member axis."""
    dt: torch.dtype
    d: str
    w: Optional[str]
    dpm: bool
    wpm: bool = False
    lut: Optional[tuple] = None   # an array param: (C name, row base, sig)


@dataclass(frozen=True)
class Out:
    """An Assign's output: env name, storage dtype, member axis of the
    data, validity presence and its member axis."""
    name: str
    dtype: torch.dtype
    pm: bool
    valid: bool
    valid_pm: bool


@dataclass
class Program:
    """One generated stage: its source, its kernel arguments (in order)
    and its outputs. `sel` is None when the stage has no Filter, else
    whether the new mask carries the member axis. `aliases` are the
    Assigns of a bare column, bound to the column's tensors after the
    launch (the plain version aliases them too). `member_loop`: an
    output carries the member axis, so the launch passes the batch's
    member count (else 1). `kernels` holds the loaded function per
    device (the launcher's memo)."""
    source: str
    args: list            # [(kind, key, ctypes type)]
    outs: list            # [Out | None] per Assign (None: an alias)
    aliases: dict         # command index -> column name
    sel: Optional[bool]
    member_loop: bool
    smem_per_member: int = 0    # shared bytes a member (k1_members' values)
    kernels: dict = field(default_factory=dict)


def _lit(value, dt: torch.dtype) -> str:
    """A C literal of a storage value (the bits the plain version's
    `torch.full` stores)."""
    if dt == torch.bool:
        return "true" if bool(value) else "false"
    if dt in _FLOATS:
        if dt == torch.float64:
            bits = int(np.float64(value).view(np.uint64))
            return f"k1_f64_bits(0x{bits:016x}ull)"
        bits = int(np.float32(value).view(np.uint32))
        return f"k1_f32_bits(0x{bits:08x}u)"
    width = torch.iinfo(dt).bits
    bits = int(value) & ((1 << width) - 1)
    return f"(({_C[dt]})0x{bits:x}ull)"


_NAMES = re.compile(r"\b(?:i|m|v\d+)\b")  # the row, the member, a value


class _Gen:
    def __init__(self, inputs: dict, psigs: dict, float_default):
        self.inputs = inputs          # name -> ColSig
        self.psigs = psigs            # name -> ParamSig
        self.fdef = float_default     # torch's default float dtype
        # (C statement, value, dtype, reads the member, reads the row)
        self.lines: list = []
        self.args: list = []          # (kind, key, ctypes type, C decl)
        self.loaded: dict = {}        # input name -> V
        self.params: dict = {}        # (name, dtype) -> V
        self.per: set = set()         # the values that read the member
        self.rows: set = set()        # the values that read the row
        self.n = 0

    # -- plumbing ----------------------------------------------------------

    def arg(self, kind, key, ctype, decl) -> None:
        self.args.append((kind, key, ctype, decl))

    def member(self, expr: str) -> bool:
        """Whether `expr` reads the member index `m`, or a value that
        does: it then goes inside the member loop, else before it."""
        return any(w == "m" or w in self.per for w in _NAMES.findall(expr))

    def row(self, expr: str) -> bool:
        """Whether `expr` reads the row index `i`, or a value that does:
        a value of the member alone is computed once a block instead."""
        return any(w == "i" or w in self.rows for w in _NAMES.findall(expr))

    def var(self, dt: torch.dtype, expr: str) -> str:
        self.n += 1
        name = f"v{self.n}"
        pm, rw = self.member(expr), self.row(expr)
        if pm:
            self.per.add(name)
        if rw:
            self.rows.add(name)
        self.lines.append((f"const {_C[dt]} {name} = {expr};", name, dt, pm,
                           rw))
        return name

    def bvar(self, expr: str) -> str:
        return self.var(torch.bool, expr)

    def cvt(self, v: V, to: torch.dtype) -> str:
        if v.dt == to:
            return v.d
        e = f"({v.d} != 0)" if to == torch.bool else f"(({_C[to]}){v.d})"
        if self.member(v.d) and not self.row(v.d):
            return self.var(to, e)      # a member's param: once a member
        return e

    def index(self, key: str, pm: bool) -> str:
        if not pm:
            return "i"
        self.arg("ms", key, ctypes.c_int64, f"const k1_i64 {key}_ms")
        return f"m * {key}_ms + i"

    def col(self, name: str) -> V:
        if name in self.loaded:
            return self.loaded[name]
        s = self.inputs[name]
        k = f"c{len(self.loaded)}"
        self.arg("col", (name, 0), ctypes.c_void_p,
                 f"const {_C[s.dtype]}* __restrict__ {k}")
        d = self.var(s.dtype, f"{k}[{self.index(k, s.pm)}]")
        w = None
        if s.valid:
            self.arg("col", (name, 1), ctypes.c_void_p,
                     f"const k1_b* __restrict__ {k}v")
            w = self.bvar(f"{k}v[{self.index(k + 'v', s.valid_pm)}]")
        v = self.loaded[name] = V(s.dtype, d, w, s.pm, s.valid_pm)
        return v

    def param(self, p: ir.Param) -> V:
        s = self.psigs[p.name]
        if p.is_array:
            key = ("arr", p.name)
            if key not in self.params:
                k = f"p{len(self.params)}"
                self.arg("param", p.name, ctypes.c_void_p,
                         f"const {_C[s.dtype]}* __restrict__ {k}")
                self.arg("plen", p.name, ctypes.c_int64,
                         f"const k1_i64 {k}_n")
                base = "0"
                if s.kind == "pm_array":
                    self.arg("pms", p.name, ctypes.c_int64,
                             f"const k1_i64 {k}_ms")
                    base = f"m * {k}_ms"
                self.params[key] = (k, base, s)
            k, base, s = self.params[key]
            return V(s.dtype, k, None, s.kind == "pm_array",
                     lut=self.params[key])
        dt = torch_dtype(p.dtype.np)
        key = (p.name, dt)
        if key in self.params:
            return self.params[key]
        k = f"p{len(self.params)}"
        if s.kind == "scalar":
            self.arg("scalar", (p.name, p.dtype.np), _CT[dt],
                     f"const {_C[dt]} {k}")
            v = V(dt, k, None, False)
        elif s.kind in ("dscalar", "pm_scalar"):
            self.arg("param", p.name, ctypes.c_void_p,
                     f"const {_C[s.dtype]}* __restrict__ {k}")
            src = V(s.dtype, f"{k}[{'m' if s.kind == 'pm_scalar' else 0}]",
                    None, False)
            v = V(dt, self.var(dt, self.cvt(src, dt)), None,
                  s.kind == "pm_scalar")
        else:
            raise Unsupported(f"param {p.name}: an array where a scalar "
                              "is expected")
        self.params[key] = v
        return v

    # -- expressions -------------------------------------------------------

    def expr(self, e, scope: dict) -> V:
        if isinstance(e, ir.Col):
            return scope[e.name] if e.name in scope else self.col(e.name)
        if isinstance(e, ir.Const):
            dt = torch_dtype(e.dtype.np)
            return V(dt, _lit(_storage_value(e.value, e.dtype.np), dt),
                     None, False)
        if isinstance(e, ir.Param):
            return self.param(e)
        if isinstance(e, ir.Call):
            emit = EMITTERS.get(e.op)
            if emit is None:
                raise Unsupported(f"no K1 emitter for op {e.op!r}")
            args = [self.expr(a, scope) for a in e.args]
            if any(a.lut is not None for a in args) != (e.op == "take_lut"):
                raise Unsupported(f"{e.op}: an array param where a value "
                                  "is expected, or a LUT that is not one")
            return emit(self, args, e.extra_dict())
        raise TypeError(f"bad expr {e!r}")

    def truth(self, e, scope: dict) -> tuple:
        """(C bool, member axis) of "`e` is TRUE", what a Filter keeps.
        Through `and` / `or` this is two-valued: a Kleene AND is TRUE iff
        every operand is, an OR iff one is; so a filter's connectives
        carry no validity (the plain version's data & valid, bit for
        bit). The member axis is the plain mask's: any operand's data
        or validity's."""
        if isinstance(e, ir.Call) and e.op in ("and", "or"):
            (a, ap), (b, bp) = (self.truth(x, scope) for x in e.args)
            sym = "&&" if e.op == "and" else "||"
            return self.bvar(f"{a} {sym} {b}"), ap or bp
        v = self.expr(e, scope)
        _need(v.dt == torch.bool, "a filter over a non-bool predicate")
        if v.w is None:
            return v.d, v.dpm
        return self.bvar(f"{v.d} && {v.w}"), v.dpm or v.wpm

    def prop(self, args, dt: torch.dtype, expr: str) -> V:
        """The propagate null rule: valid iff every argument is (the
        plain version ANDs the validities left to right)."""
        ws = [a for a in args if a.w is not None]
        w = None
        if ws:
            w = ws[0].w if len(ws) == 1 else self.bvar(
                " && ".join(a.w for a in ws))
        return V(dt, self.var(dt, expr), w,
                 any(a.dpm for a in args), any(a.wpm for a in ws))


def _storage_value(value, np_dtype):
    """The value the plain version's `torch.full` stores for a constant
    or host-scalar param (uint64 as its int64 bits)."""
    from ydb_tpu_torch.ops.torch_exec import _full
    return _full(1, value, np_dtype, "cpu")[0].item()


# -- emitters: (gen, [V], extra) -> V ---------------------------------------


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise Unsupported(what)


def _arith(op):
    def emit(g, args, extra):
        a, b = args
        t = torch.promote_types(a.dt, b.dt)
        _need(op != "sub" and t != torch.bool or op in ("add", "mul")
              or torch.bool not in (a.dt, b.dt), f"{op} of a bool")
        return g.prop(args, t, f"k1_{op}({g.cvt(a, t)}, {g.cvt(b, t)})")
    return emit


def _div(g, args, extra):
    # kernels.py _safe_div: ints divide as float64, a zero divisor gives
    # 0; a float numerator keeps its dtype (the divisor converts to it);
    # bools divide in torch's default float
    a, b = args
    t = torch.float64 if a.dt in _INTS else a.dt
    den = V(t, g.var(t, g.cvt(b, t)), None, b.dpm)
    z = g.bvar(f"{den.d} == ({_C[t]})0")
    if t == torch.bool:
        t = g.fdef
    x, y = g.cvt(a, t), g.cvt(den, t)
    return g.prop(args, t, f"({z} ? ({_C[t]})0 : {x}) / "
                           f"({z} ? ({_C[t]})1 : {y})")


def _floor_op(fn):
    # a // where(b == 0, 1, b) and a % where(b == 0, 1, b)
    def emit(g, args, extra):
        a, b = args
        _need(torch.bool not in (a.dt, b.dt), f"{fn} of a bool")
        c = g.var(b.dt, f"{b.d} == ({_C[b.dt]})0 ? ({_C[b.dt]})1 : {b.d}")
        t = torch.promote_types(a.dt, b.dt)
        cv = V(b.dt, c, None, b.dpm)
        return g.prop(args, t, f"{fn}({g.cvt(a, t)}, {g.cvt(cv, t)})")
    return emit


def _unary(fn, ok):
    def emit(g, args, extra):
        (a,) = args
        _need(a.dt in ok, f"{fn} of {a.dt}")
        return g.prop(args, a.dt, f"{fn}({a.d})")
    return emit


def _cmp(sym):
    def emit(g, args, extra):
        a, b = args
        t = torch.promote_types(a.dt, b.dt)
        return g.prop(args, torch.bool, f"{g.cvt(a, t)} {sym} {g.cvt(b, t)}")
    return emit


def _kleene(op):
    def emit(g, args, extra):
        a, b = args
        _need(a.dt == torch.bool and b.dt == torch.bool, f"{op} of non-bools")
        if a.w is None and b.w is None:
            sym = "&&" if op == "and" else "||"
            return V(torch.bool, g.bvar(f"{a.d} {sym} {b.d}"), None,
                     a.dpm or b.dpm)
        ta, tap = (a.w, a.wpm) if a.w is not None else ("true", a.dpm)
        tb, tbp = (b.w, b.wpm) if b.w is not None else ("true", b.dpm)
        pm = a.dpm or b.dpm or tap or tbp
        xs = f"{a.d}, {ta}, {b.d}, {tb}"
        return V(torch.bool, g.bvar(f"k1_kleene_{op}_d({xs})"),
                 g.bvar(f"k1_kleene_{op}_v({xs})"), pm, pm)
    return emit


def _not(g, args, extra):
    (a,) = args
    if a.dt == torch.bool:
        return g.prop(args, a.dt, f"!{a.d}")
    _need(a.dt in _INTS, f"not of {a.dt}")
    return g.prop(args, a.dt, f"({_C[a.dt]})~{a.d}")


def _xor(g, args, extra):
    a, b = args
    t = torch.promote_types(a.dt, b.dt)
    if t == torch.bool:
        return g.prop(args, t, f"{a.d} != {b.d}")
    _need(t in _INTS, f"xor of {t}")
    return g.prop(args, t, f"({_C[t]})({g.cvt(a, t)} ^ {g.cvt(b, t)})")


def _if(g, args, extra):
    c, a, b = args
    _need(c.dt == torch.bool, "if over a non-bool condition")
    cond, cpm = c.d, c.dpm
    if c.w is not None:
        cond, cpm = g.bvar(f"{c.d} && {c.w}"), c.dpm or c.wpm
    t = torch.promote_types(a.dt, b.dt)
    dpm = cpm or a.dpm or b.dpm
    d = g.var(t, f"{cond} ? {g.cvt(a, t)} : {g.cvt(b, t)}")
    if a.w is None and b.w is None:
        return V(t, d, None, dpm)
    ta, tap = (a.w, a.wpm) if a.w is not None else ("true", dpm)
    tb, tbp = (b.w, b.wpm) if b.w is not None else ("true", dpm)
    return V(t, d, g.bvar(f"{cond} ? {ta} : {tb}"), dpm,
             cpm or tap or tbp)


def _typed_null(g, args, extra):
    (a,) = args
    return V(a.dt, a.d, "false", a.dpm, a.dpm)


def _coalesce(g, args, extra):
    a, b = args
    if a.w is None:
        return V(a.dt, a.d, None, a.dpm)
    t = torch.promote_types(a.dt, b.dt)
    d = g.var(t, f"{a.w} ? {g.cvt(a, t)} : {g.cvt(b, t)}")
    dpm = a.wpm or a.dpm or b.dpm
    if b.w is None:
        return V(t, d, None, dpm)
    return V(t, d, g.bvar(f"{a.w} || {b.w}"), dpm, a.wpm or b.wpm)


def _is_null(negate: bool):
    def emit(g, args, extra):
        (a,) = args
        if a.w is None:
            return V(torch.bool, "true" if negate else "false", None, a.dpm)
        return V(torch.bool, a.w if negate else g.bvar(f"!{a.w}"), None,
                 a.wpm)
    return emit


def _floor_ceil(fn):
    def emit(g, args, extra):
        (a,) = args
        _need(a.dt != torch.bool, f"{fn} of a bool")
        if a.dt in _INTS:                  # torch returns the ints as they are
            return g.prop(args, a.dt, a.d)
        return g.prop(args, a.dt, f"k1_{fn}({a.d})")
    return emit


def _round(g, args, extra):
    # sign(a) * floor(abs(a) + 0.5); an int's abs + 0.5 is torch's
    # default float
    (a,) = args
    _need(a.dt != torch.bool, "round of a bool")
    if a.dt in _FLOATS:
        c = _C[a.dt]
        return g.prop(args, a.dt, f"k1_mul(k1_sign({a.d}), k1_floor("
                                  f"k1_add(k1_abs({a.d}), ({c})0.5)))")
    f = g.fdef
    return g.prop(args, f, f"k1_mul(({_C[f]})k1_sign({a.d}), k1_floor("
                           f"k1_add(({_C[f]})k1_abs({a.d}), ({_C[f]})0.5)))")


def _inexact(g, dt: torch.dtype) -> torch.dtype:
    # torch_ns._inexact: int64 → float64, narrower ints → the default
    return dt if dt in _FLOATS else (torch.float64 if dt == torch.int64
                                     else g.fdef)


def _sqrt(g, args, extra):
    # sqrt(clamp_min(a, 0)): an int clamps as an int, then turns inexact
    (a,) = args
    _need(a.dt != torch.bool, "sqrt of a bool")
    t = _inexact(g, a.dt)
    m = f"k1_clamp_min({a.d}, ({_C[a.dt]})0)"
    return g.prop(args, t, f"k1_sqrt(({_C[t]}){m})")


def _exp(g, args, extra):
    (a,) = args
    t = _inexact(g, a.dt)
    return g.prop(args, t, f"k1_exp({g.cvt(a, t)})")


def _ln(g, args, extra):
    # log(clamp_min(a, 1e-300)): an int or bool clamps as float64
    # (torch_ns.maximum); a float32 clamps in float32, where 1e-300 is 0
    (a,) = args
    t = a.dt if a.dt in _FLOATS else torch.float64
    lo = _lit(1e-300, t)
    return g.prop(args, t, f"k1_log(k1_clamp_min({g.cvt(a, t)}, {lo}))")


def _pow(g, args, extra):
    a, b = args
    t = torch.promote_types(a.dt, b.dt)
    _need(t != torch.bool, "pow of bools")
    return g.prop(args, t, f"k1_pow({g.cvt(a, t)}, {g.cvt(b, t)})")


def _cast(g, args, extra):
    (a,) = args
    to = torch_dtype(DType(Kind(extra["to"])).np)
    return g.prop(args, to, g.cvt(a, to))


def _civil(which):
    def emit(g, args, extra):
        (a,) = args
        return g.prop(args, torch.int32,
                      f"k1_civil({g.cvt(a, torch.int64)}, {which})")
    return emit


def _time_of_day(div, mod):
    # (a // div) % mod, the scalars in a's dtype (torch converts them as
    # a C cast does), then int32
    def emit(g, args, extra):
        (a,) = args
        _need(a.dt != torch.bool, "time of day of a bool")
        c = _C[a.dt]
        x = a.d if div is None else f"k1_floordiv({a.d}, ({c}){div})"
        return g.prop(args, torch.int32, f"(k1_i32)k1_mod({x}, ({c}){mod})")
    return emit


def _take_lut(g, args, extra) -> V:
    """lut[clamp(code, 0, L - 1)]; a negative code is NULL; with
    `null_neg` a negative LUT value is NULL too (kernels.py
    _take_lut_nv, torch_exec._take_lut_members for a (B, L) LUT)."""
    a, lv = args
    _need(lv.lut is not None and a.lut is None, "take_lut without a LUT")
    k, base, s = lv.lut
    _need(a.dt in _INTS, f"take_lut with {a.dt} codes")
    c = _C[a.dt]
    safe = g.var(torch.int64, f"{a.d} < ({c})0 ? 0 : ((k1_i64){a.d} > "
                              f"{k}_n - 1 ? {k}_n - 1 : (k1_i64){a.d})")
    pm_lut = s.kind == "pm_array"
    d = g.var(s.dtype, f"{k}[{base} + {safe}]")
    nul = f"({a.d} < ({c})0)"
    w = f"!{nul}" if a.w is None else f"{a.w} && !{nul}"
    wpm = a.dpm or (a.w is not None and a.wpm)
    if extra.get("null_neg"):
        w = f"{w} && ({d} >= 0)"
        wpm = wpm or a.dpm or pm_lut
    return V(s.dtype, d, g.bvar(w), a.dpm or pm_lut, wpm)


def _hash64(g, args, extra):
    (a,) = args
    return g.prop(args, torch.int64,
                  f"k1_splitmix64({g.cvt(a, torch.int64)})")


def _hash_combine(g, args, extra):
    if len(args) == 1:                     # the plain version returns it
        return g.prop(args, args[0].dt, args[0].d)
    h = g.cvt(args[0], torch.int64)
    for x in args[1:]:
        h = f"k1_hash_combine({h}, {g.cvt(x, torch.int64)})"
    return g.prop(args, torch.int64, h)


EMITTERS = {
    "add": _arith("add"), "sub": _arith("sub"), "mul": _arith("mul"),
    "div": _div, "idiv": _floor_op("k1_floordiv"),
    "mod": _floor_op("k1_mod"),
    "neg": _unary("k1_neg", _INTS + _FLOATS),
    "abs": _unary("k1_abs", _INTS + _FLOATS),
    "eq": _cmp("=="), "ne": _cmp("!="), "lt": _cmp("<"), "le": _cmp("<="),
    "gt": _cmp(">"), "ge": _cmp(">="),
    "and": _kleene("and"), "or": _kleene("or"), "not": _not, "xor": _xor,
    "if": _if, "typed_null": _typed_null, "coalesce": _coalesce,
    "is_null": _is_null(False), "is_not_null": _is_null(True),
    "floor": _floor_ceil("floor"), "ceil": _floor_ceil("ceil"),
    "round": _round, "sqrt": _sqrt, "exp": _exp, "ln": _ln, "pow": _pow,
    "cast": _cast,
    "year": _civil(0), "month": _civil(1), "day_of_month": _civil(2),
    "hour_of_day": _time_of_day(3600, 24),
    "minute_of_hour": _time_of_day(60, 60),
    "second_of_minute": _time_of_day(None, 60),
    "take_lut": _take_lut,
    "hash64": _hash64, "hash_combine": _hash_combine,
}


def generate(cmds: tuple, inputs: dict, psigs: dict,
             sel: Optional[ColSig]) -> Program:
    """CUDA C++ for one stage (Assign/Filter commands without a
    composite hash key) over its input signature. `sel` is the incoming
    mask's signature (dtype bool, `pm`) or None."""
    g = _Gen(inputs, psigs, torch.get_default_dtype())
    scope: dict = {}
    outs, aliases, stores = [], {}, []
    s_var, s_pm = None, False
    if sel is not None and any(isinstance(c, ir.Filter) for c in cmds):
        g.arg("sel", None, ctypes.c_void_p, "const k1_b* __restrict__ s_in")
        s_var = g.bvar(f"s_in[{g.index('s_in', sel.pm)}]")
        s_pm = sel.pm
    for j, cmd in enumerate(cmds):
        if isinstance(cmd, ir.Assign):
            if isinstance(cmd.expr, ir.Col):   # bound, not copied
                src = cmd.expr.name
                aliases[j] = src
                outs.append(None)
                scope[cmd.name] = scope[src] if src in scope else g.col(src)
                continue
            v = g.expr(cmd.expr, scope)
            scope[cmd.name] = v
            k = len(outs)
            outs.append(Out(cmd.name, v.dt, v.dpm, v.w is not None,
                            v.w is not None and v.wpm))
            stores.append((k, v))
        elif isinstance(cmd, ir.Filter):
            mask, mpm = g.truth(cmd.pred, scope)
            s_var = mask if s_var is None else g.bvar(f"{s_var} && {mask}")
            s_pm = s_pm or mpm
        else:
            raise TypeError(f"not a stage command: {cmd!r}")
    # the member-invariant lines once, then the member loop with the
    # lines that read the member and the row, and the per-member stores;
    # the values of the member alone (its params, their conversions) are
    # computed by k1_members, once a member for the whole block, which
    # the loop reads back from shared memory; k1_members emits, in
    # order, every line that does not read the row (those of the member
    # alone and the constants and shared params they read)
    shared = [t for t, _v, _d, pm, _r in g.lines if not pm]
    per = [t for t, _v, _d, pm, rw in g.lines if pm and rw]
    alone = [(v, dt) for _t, v, dt, pm, rw in g.lines if pm and not rw]
    no_row = [t for t, _v, _d, _pm, rw in g.lines if not rw]

    def store(ptr: str, val: str, pm: bool) -> None:
        if pm:
            per.append(f"{ptr}[m * n + i] = {val};")
        elif g.member(val):
            raise RuntimeError(f"K1: the shared output {ptr} reads the "
                               "member index")
        else:
            shared.append(f"{ptr}[i] = {val};")

    for k, v in stores:
        o = outs[k]
        g.arg("out", (k, 0), ctypes.c_void_p, f"{_C[o.dtype]}* __restrict__ o{k}")
        store(f"o{k}", v.d, o.pm)
        if o.valid:
            g.arg("out", (k, 1), ctypes.c_void_p, f"k1_b* __restrict__ o{k}v")
            store(f"o{k}v", v.w, o.valid_pm)
    has_filter = any(isinstance(c, ir.Filter) for c in cmds)
    if has_filter:
        g.arg("selout", None, ctypes.c_void_p, "k1_b* __restrict__ s_out")
        store("s_out", s_var, s_pm)
    member_loop = any(o is not None and (o.pm or o.valid_pm)
                      for o in outs) or (has_filter and s_pm)
    decls = ", ".join([a[3] for a in g.args]
                      + ["const k1_i64 n", "const k1_i64 members"])
    names = ", ".join([a[3].split()[-1] for a in g.args] + ["n", "members"])
    # the member's values the loop reads: an array of `members` 8-byte
    # slots each in shared memory (on the host, in a heap block)
    used = set(_NAMES.findall("\n".join(per)))
    kept = [(v, dt) for v, dt in alone if v in used]
    sm = [f"s{j}" for j in range(len(kept))]
    sm_decls = "".join(f", {_C[dt]}* __restrict__ {a}"
                       for a, (_v, dt) in zip(sm, kept))
    sm_names = "".join(f", {a}" for a in sm)
    sm_ptrs = [f"  {_C[dt]}* {a} = ({_C[dt]}*)(k1_sm + {j} * members);"
               for j, (a, (_v, dt)) in enumerate(zip(sm, kept))]
    body = [f"  {t}" for t in shared]
    if per:
        body += ["  for (k1_i64 m = 0; m < members; ++m) {",
                 *[f"    const {_C[dt]} {v} = {a}[m];"
                   for a, (v, dt) in zip(sm, kept)],
                 *[f"    {t}" for t in per], "  }"]
    prologue, members_fn = [], []
    if kept:
        members_fn = [
            f"K1_DEV void k1_members(const k1_i64 m, {decls}{sm_decls}) {{",
            *[f"  {t}" for t in no_row],
            *[f"  {a}[m] = {v};" for a, (v, _d) in zip(sm, kept)],
            "}"]
        prologue = [
            "  extern __shared__ k1_u64 k1_sm[];", *sm_ptrs,
            "  for (k1_i64 m = threadIdx.x; m < members; m += blockDim.x)",
            f"    k1_members(m, {names}{sm_names});",
            "  __syncthreads();"]
    src = "\n".join([
        _prelude(),
        "// ---- generated stage ----",
        *members_fn,
        f"K1_DEV void k1_row(const k1_i64 i, {decls}{sm_decls}) {{",
        *body,
        "}",
        "#ifdef K1_DEVICE",
        f'extern "C" __global__ void {ENTRY}({decls}) {{',
        *prologue,
        "  const k1_i64 i = (k1_i64)blockIdx.x * blockDim.x + threadIdx.x;",
        "  if (i >= n) return;",
        f"  k1_row(i, {names}{sm_names});",
        "}",
        "#else",
        "#ifndef K1_HOST_ENTRY",
        "#define K1_HOST_ENTRY k1_host",
        "#endif",
        f'extern "C" void K1_HOST_ENTRY({decls}) {{',
        *([f"  k1_u64* k1_sm = new k1_u64[{len(kept)} * members + 1];",
           *sm_ptrs,
           "  for (k1_i64 m = 0; m < members; ++m)",
           f"    k1_members(m, {names}{sm_names});"] if kept else []),
        f"  for (k1_i64 i = 0; i < n; ++i) k1_row(i, {names}{sm_names});",
        *(["  delete[] k1_sm;"] if kept else []),
        "}",
        "#endif",
        ""])
    return Program(src, [(a[0], a[1], a[2]) for a in g.args], outs, aliases,
                   s_pm if has_filter else None, member_loop,
                   8 * len(kept))


# --------------------------------------------------------------------------
# stages: composite hash keys split out, then one launch each
# --------------------------------------------------------------------------


def _is_hashed_key(e) -> bool:
    return (isinstance(e, ir.Call) and e.op == "hash_combine"
            and all(isinstance(a, ir.Call) and a.op == "hash64"
                    for a in e.args))


def _hashed_nodes(e, out: list) -> list:
    if _is_hashed_key(e):
        if e not in out:
            out.append(e)
    elif isinstance(e, ir.Call):
        for a in e.args:
            _hashed_nodes(a, out)
    return out


def _replace(e, reps: dict):
    if isinstance(e, ir.Call):
        if e in reps:
            return reps[e]
        return ir.Call(e.op, tuple(_replace(a, reps) for a in e.args),
                       e.extra)
    return e


def split_stage(stage) -> list:
    """The stage as segments, in order: ("k1", commands) — one launch —
    and ("hash", name, node) — a composite hash key through the K12
    route into a synthetic column `name` (its arguments, when not plain
    columns, computed by a "k1" segment before it). A command reads the
    key as that column."""
    segs, pending, assigned = [], [], set()
    n = 0

    def flush():
        nonlocal pending
        if pending:
            segs.append(("k1", tuple(pending)))
            pending = []
            assigned.clear()

    for cmd in stage:
        e = cmd.expr if isinstance(cmd, ir.Assign) else cmd.pred
        reps: dict = {}
        for node in _hashed_nodes(e, []):
            inner = [a.args[0] for a in node.args]
            refs: set = set()
            for x in inner:
                ir.expr_columns(x, refs)
            if refs & assigned:
                flush()
            pre, cols = [], []
            for x in inner:
                if isinstance(x, ir.Col):
                    cols.append(x)
                else:
                    nm = f"__k1a{n}"
                    n += 1
                    pre.append(ir.Assign(nm, x))
                    cols.append(ir.Col(nm))
            if pre:
                segs.append(("k1", tuple(pre)))
            nm = f"__k1h{n}"
            n += 1
            segs.append(("hash", nm, ir.Call(
                "hash_combine", tuple(ir.Call("hash64", (c,)) for c in cols),
                node.extra)))
            reps[node] = ir.Col(nm)
        if reps:
            cmd = ir.Assign(cmd.name, _replace(e, reps)) \
                if isinstance(cmd, ir.Assign) else ir.Filter(_replace(e, reps))
        pending.append(cmd)
        if isinstance(cmd, ir.Assign):
            assigned.add(cmd.name)
    flush()
    return segs


def stage_inputs(cmds) -> tuple:
    """(input column names in first-read order, params) of a segment."""
    names, params, assigned = [], {}, set()

    def walk(e):
        if isinstance(e, ir.Col):
            if e.name not in assigned and e.name not in names:
                names.append(e.name)
        elif isinstance(e, ir.Param):
            params.setdefault(e.name, e)
        elif isinstance(e, ir.Call):
            for a in e.args:
                walk(a)

    for cmd in cmds:
        walk(cmd.expr if isinstance(cmd, ir.Assign) else cmd.pred)
        if isinstance(cmd, ir.Assign):
            assigned.add(cmd.name)
    return tuple(names), tuple(params.values())


# --------------------------------------------------------------------------
# running a stage
# --------------------------------------------------------------------------

_MU = threading.Lock()             # guards the memos below
_KEYS: dict = {}                   # id(stage) -> (stage, its repr)
_SPLITS: dict = {}                 # stage repr -> segments
_INPUTS: dict = {}                 # segment key -> stage_inputs
_PROGRAMS: dict = {}               # (segment key, signature) -> Program
_MEMO_MAX = 1 << 14


def run_stage(stage, env: dict, params: dict, sel, cap: int, device):
    """Run a stage's Assign and Filter commands over `env` (updated in
    place); returns the new selection mask. CUDA tensors launch the
    stage's generated kernel, one launch per stage (``LAUNCHES["k1"]``
    counts them); CPU tensors run the plain version."""
    if torch.device(device).type != "cuda":
        return run_stage_plain(stage, env, params, sel, cap, device)
    from ydb_tpu_torch.ops.cuda import nvrtc
    return run_stage_compiled(stage, env, params, sel, cap, device,
                              nvrtc.LAUNCHER)


def run_stage_plain(stage, env: dict, params: dict, sel, cap: int, device):
    """The plain version: torch over ``ops/kernels.py``, command by
    command (``torch_exec._eval``)."""
    from ydb_tpu_torch.ops.torch_exec import _eval
    for cmd in stage:
        if isinstance(cmd, ir.Assign):
            env[cmd.name] = _eval(cmd.expr, env, params, cap, device)
        else:
            data, valid = _eval(cmd.pred, env, params, cap, device)
            mask = data if valid is None else (data & valid)
            sel = mask if sel is None else (sel & mask)
    return sel


def _memo_put(memo: dict, key, value):
    with _MU:
        if len(memo) >= _MEMO_MAX:
            memo.clear()
        memo[key] = value
    return value


def stage_key(stage) -> str:
    """The stage's identity (its commands' repr, which tells -0.0 from
    0.0), computed once per stage object."""
    hit = _KEYS.get(id(stage))
    if hit is not None and hit[0] is stage:
        return hit[1]
    return _memo_put(_KEYS, id(stage), (stage, repr(tuple(stage))))[1]


def stage_segments(stage) -> list:
    key = stage_key(stage)
    segs = _SPLITS.get(key)
    if segs is None:
        segs = _memo_put(_SPLITS, key, split_stage(stage))
    return [(key, j, seg) for j, seg in enumerate(segs)]


def run_stage_compiled(stage, env: dict, params: dict, sel, cap: int,
                       device, launcher):
    """The kernel route over a `launcher`: ``nvrtc.LAUNCHER`` on the
    card; the CPU tests pass one that runs the same source compiled by
    the host's C++ compiler."""
    from ydb_tpu_torch.ops.torch_exec import _eval_hashed_key
    synthetic = []
    try:
        for key, j, seg in stage_segments(stage):
            if seg[0] == "hash":
                env[seg[1]] = _eval_hashed_key(seg[2], env, params, cap,
                                               device)
                synthetic.append(seg[1])
                continue
            sel = run_segment((key, j), seg[1], env, params, sel, cap,
                              device, launcher)
            synthetic += [c.name for c in seg[1] if isinstance(c, ir.Assign)
                          and c.name.startswith("__k1a")]
    finally:
        for nm in synthetic:
            env.pop(nm, None)
    return sel


def _inputs_of(key, cmds) -> tuple:
    hit = _INPUTS.get(key)
    return hit if hit is not None else _memo_put(_INPUTS, key,
                                                 stage_inputs(cmds))


def signature(key, cmds, env, params, sel) -> tuple:
    """The input signature a program is generated for."""
    names, ps = _inputs_of(key, cmds)
    cols = tuple(_col_sig(env[n]) for n in names)
    psigs = tuple(_param_sig(p, params[p.name]) for p in ps)
    ssig = None if sel is None else ColSig(torch.bool, sel.dim() == 2,
                                           False, False)
    return cols, psigs, ssig, torch.get_default_dtype()


def program_for(key, cmds, env, params, sel) -> Program:
    """The segment's generated program for this input signature,
    generated once per process."""
    sig = signature(key, cmds, env, params, sel)
    prog = _PROGRAMS.get((key, sig))
    if prog is None:
        names, ps = _inputs_of(key, cmds)
        cols, psigs, ssig, _f = sig
        prog = _memo_put(_PROGRAMS, (key, sig), generate(
            cmds, dict(zip(names, cols)),
            {p.name: s for p, s in zip(ps, psigs)}, ssig))
    return prog


def _members(key, cmds, env, params, sel) -> int:
    from ydb_tpu_torch.ops.torch_exec import PerMember
    names, ps = _inputs_of(key, cmds)
    for n in names:
        for t in env[n]:
            if t is not None and t.dim() == 2:
                return t.shape[0]
    for p in ps:
        if isinstance(params[p.name], PerMember):
            return params[p.name].t.shape[0]
    if sel is not None and sel.dim() == 2:
        return sel.shape[0]
    return 1


def run_segment(key, cmds, env, params, sel, cap: int, device, launcher):
    """One launch of a segment's program; its outputs bound into `env`.
    Returns the new selection mask."""
    from ydb_tpu_torch.ops.torch_exec import PerMember
    prog = program_for(key, cmds, env, params, sel)
    B = _members(key, cmds, env, params, sel)
    dev = torch.device(device)

    def tensor(t):
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device != dev):
            raise ValueError(f"K1 input on {t.device}, expected {dev}")
        if t.dim() and t.stride(-1) != 1 and t.shape[-1] > 1:
            t = t.contiguous()
        inputs.append(t)
        return t

    # the inputs first (checked before anything is allocated; `inputs`
    # holds any contiguous copy until the launch is queued), then the
    # outputs' slots
    vals, inputs, last = [], [], None
    for kind, k, ct in prog.args:
        if kind == "col":
            last = tensor(env[k[0]][k[1]])
            vals.append(ct(last.data_ptr()))
        elif kind in ("ms", "pms"):
            vals.append(ct(last.stride(0)))
        elif kind == "param":
            val = params[k]
            t = val.t if isinstance(val, PerMember) else val
            last = tensor(t.reshape(1) if t.dim() == 0 else t)
            vals.append(ct(last.data_ptr()))
        elif kind == "plen":
            vals.append(ct(last.shape[-1]))
        elif kind == "scalar":
            vals.append(ct(_storage_value(params[k[0]], k[1])))
        elif kind == "sel":
            last = tensor(sel)
            vals.append(ct(last.data_ptr()))
        else:
            vals.append(None)

    def empty(pm, dtype):
        return torch.empty((B, cap) if pm else (cap,), dtype=dtype,
                           device=dev)

    outs = [None if o is None else
            (empty(o.pm, o.dtype),
             empty(o.valid_pm, torch.bool) if o.valid else None)
            for o in prog.outs]
    sel_out = None if prog.sel is None else empty(prog.sel, torch.bool)
    for i, (kind, k, ct) in enumerate(prog.args):
        if kind == "out":
            vals[i] = ct(outs[k[0]][k[1]].data_ptr())
        elif kind == "selout":
            vals[i] = ct(sel_out.data_ptr())
    # a stage of bare-column Assigns alone has nothing to compute
    work = any(o is not None for o in outs) or sel_out is not None
    if work and cap > 0:
        launcher.launch(prog, vals, cap, B if prog.member_loop else 1, dev)
    a = 0
    for j, cmd in enumerate(cmds):
        if isinstance(cmd, ir.Assign):
            env[cmd.name] = env[prog.aliases[j]] if j in prog.aliases \
                else outs[a]
            a += 1
    return sel if prog.sel is None else sel_out


class _DryRun:
    """A launcher that launches nothing (signatures and generation only)."""

    def launch(self, prog, args, n, members, device) -> None:
        pass


def supports(stage, env: dict, params: dict, sel=None) -> bool:
    """Whether the generator emits every segment of `stage` over the
    signature of these (CPU) inputs. Generates, compiles nothing."""
    cap = next((d.shape[-1] for d, _v in env.values()), 0)
    try:
        run_stage_compiled(stage, dict(env), params, sel, cap, "cpu",
                           _DryRun())
    except Unsupported:
        return False
    return True
