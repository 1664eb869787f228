"""K1 ×B (``ydb_tpu_torch/ops/k1.py``): a stage over a batch's members as
one generated kernel on a 1-D grid, each thread evaluating the
member-invariant part of its row once and looping over the members for
the rest, held on the CPU.

- The generated source of stages over every kind of input, compiled by
  the host's ``g++`` (the row function and its host loop, as
  ``tests/test_torch_k1.py`` does) and run over the tensors' memory, at
  B = 1, 2, 3, 8 and 33: shared columns with and without validity,
  per-member columns (with per-member or shared validity), host and
  ``PerMember`` (B,) scalars, shared (L,) and ``PerMember`` (B, L)
  LUTs, shared and per-member outputs, filters after no mask, a shared
  mask and a per-member one, a filter's connectives over NULLs,
  alias-only stages, and 0 rows: every
  output equals ``k1.run_stage_plain`` bit for bit, in dtype, shape and
  validity.
- The source's structure: each shared column (and its validity) is
  loaded once, before the member loop; per-member loads and stores are
  inside it; a member's (B,) params and their conversions are computed
  once a member for the block (``k1_members``, shared memory) and read
  back in the loop; shared outputs are stored once, outside it; a stage
  with no per-member output has no loop; the kernel takes ``n`` and
  ``members`` last and its host entry loops over the rows alone; a
  filter's ``and`` / ``or`` carry no Kleene validity.
- The batched answers: TPC-H q19 (B = 8, ``serving.variants``) and the
  orders point lookups (B = 8 and 33) through the port's batched lane
  with every K1 stage run by its host-compiled source equal the JAX
  engine's batched lane.
"""

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ydb_tpu.query import QueryEngine as JaxEngine
from ydb_tpu.sql import parse as jax_parse

from ydb_tpu_torch.bench import serving
from ydb_tpu_torch.core.dtypes import DType, Kind
from ydb_tpu_torch.ops import ir, k1
from ydb_tpu_torch.ops.torch_exec import PerMember
from ydb_tpu_torch.query import QueryEngine as PortEngine
from ydb_tpu_torch.sql import parse as port_parse

from tests.tpch_util import assert_frames_match
from tests import torch_threads  # noqa: F401,E402

N = 193
L = 23
SEED = 20261019
CPU = torch.device("cpu")
MEMBERS = [1, 2, 3, 8, 33]
LOOP = "for (k1_i64 m = 0; m < members; ++m) {"


class HostLauncher:
    """Runs a generated stage's source compiled by the host's g++ (the
    prelude, the row function and the host entry's loop over the rows);
    records the member counts it was launched with."""

    def __init__(self, workdir):
        self.dir = str(workdir)
        self.fns = {}
        self.members = []

    def _compile(self, prog) -> str:
        h = hashlib.sha1(prog.source.encode()).hexdigest()[:20]
        so = os.path.join(self.dir, f"lib{h}.so")
        if not os.path.exists(so):
            src = os.path.join(self.dir, f"{h}.cc")
            with open(src, "w") as f:
                f.write(prog.source)
            subprocess.run(["g++", "-O1", "-ffp-contract=off", "-shared",
                            "-fPIC", "-o", so + ".tmp", src], check=True,
                           capture_output=True, text=True)
            os.replace(so + ".tmp", so)
        return so

    def prebuild(self, progs) -> None:
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(self._compile, {p.source: p for p in progs}
                        .values()))

    def launch(self, prog, args, n, members, device) -> None:
        so = self._compile(prog)
        fn = self.fns.get(so)
        if fn is None:
            fn = self.fns[so] = ctypes.CDLL(so).k1_host
            fn.restype = None
        self.members.append(members)
        fn(*args, ctypes.c_int64(n), ctypes.c_int64(members))


class Recorder:
    def __init__(self):
        self.progs = []

    def launch(self, prog, args, n, members, device) -> None:
        self.progs.append(prog)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return HostLauncher(tmp_path_factory.mktemp("k1_members"))


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

I64, I32, F64 = DType(Kind.INT64), DType(Kind.INT32), DType(Kind.FLOAT64)


def _inputs(B: int, n: int, seed: int = SEED):
    """Columns and params of every kind over B members and n rows."""
    rng = np.random.default_rng([seed, B, n])

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    b = rng.normal(size=n) * 50
    b[:3] = [np.nan, -0.0, np.inf][:min(3, n)]
    env = {
        "a": (t(rng.integers(-60, 60, n)), None),
        "b": (t(b), t(rng.random(n) < 0.8)),
        "c": (t(rng.integers(-2, L + 3, n).astype(np.int32)),
              t(rng.random(n) < 0.9)),
        "f": (t(rng.random(n) < 0.5), None),
        "pa": (t(rng.integers(-60, 60, (B, n))), None),
        "pb": (t(rng.normal(size=(B, n)) * 9), t(rng.random((B, n)) < 0.7)),
        "pd": (t(rng.integers(-9, 9, (B, n)).astype(np.int32)),
               t(rng.random(n) < 0.6)),
    }
    params = {
        "k": PerMember(t(rng.integers(-30, 30, B))),
        "s": PerMember(t(rng.normal(size=B))),
        "lut": PerMember(t(rng.integers(-3, 40, (B, L)).astype(np.int32))),
        "lut0": t(rng.integers(-3, 40, L).astype(np.int32)),
        "h": int(rng.integers(-10, 10)),
        "z": float(rng.normal()),
        "lim": PerMember(t(rng.integers(-40, 60, B))),
    }
    masks = t(rng.random((B, n)) < 0.7)
    params["d"] = torch.tensor(int(rng.integers(-10, 10)))     # 0-d
    return env, params, masks


def _c(name):
    return ir.Col(name)


def _p(name, dt=I64, array=False):
    return ir.Param(name, dt, is_array=array)


STAGES = {
    # shared and per-member outputs from every kind of input
    "mixed": (
        ir.Assign("x", ir.call("add", _c("a"), _p("k"))),
        ir.Assign("y", ir.call("mul", _c("b"), _p("z", F64))),
        ir.Assign("w", ir.call("take_lut", _c("c"), _p("lut", I32, True),
                               null_neg=True)),
        ir.Assign("u", ir.call("take_lut", _c("c"), _p("lut0", I32, True))),
        ir.Assign("v", ir.call("if", ir.call("gt", _c("pa"), _p("h")),
                               _c("b"), _p("s", F64))),
        ir.Assign("q", ir.call("coalesce", _c("pb"), _c("b"))),
        ir.Assign("r", ir.call("add", _c("pd"), _c("a"))),
        ir.Assign("e", ir.call("and", _c("f"), ir.call(
            "lt", _c("a"), _p("h")))),
        ir.Assign("t", ir.call("ge", _c("b"), _p("lim"))),
        ir.Filter(ir.call("lt", _c("x"), _p("lim"))),
        ir.Filter(ir.call("is_not_null", _c("y")))),
    # shared outputs only, over shared inputs: no member loop
    "shared_only": (
        ir.Assign("y", ir.call("mul", _c("b"), _p("z", F64))),
        ir.Assign("g", ir.call("sub", _c("a"), _p("h"))),
        ir.Filter(ir.call("ge", _c("g"), ir.Const(0, I64)))),
    # a filter over shared data, its mask per member only by the params
    "pm_filter": (
        ir.Filter(ir.call("and", ir.call("gt", _c("b"), _p("s", F64)),
                          ir.call("le", _c("a"), _p("lim")))),),
    # a LUT per member over shared codes, and a filter on its validity
    "pm_lut": (
        ir.Assign("w", ir.call("take_lut", _c("c"), _p("lut", I32, True))),
        ir.Filter(ir.call("is_not_null", _c("w")))),
    # a filter's connectives over NULLs, shared and per-member operands
    "kleene_filter": (
        ir.Filter(ir.call("or", ir.call(
            "and", ir.call("gt", _c("b"), _p("s", F64)),
            ir.call("le", _c("pa"), _p("lim"))), ir.call(
            "and", ir.call("lt", _c("b"), _p("z", F64)),
            ir.call("gt", _c("pd"), _c("c"))))),),
    # a member's values over constants, host scalars and a 0-d tensor:
    # lines that read neither the member nor the row feed k1_members
    "member_consts": (
        ir.Assign("x1", ir.call("add", _c("b"), ir.call(
            "div", _p("k"), ir.Const(2, I64)))),
        ir.Assign("x2", ir.call("add", _c("a"), ir.call(
            "mod", _p("k"), _p("h")))),
        ir.Assign("x3", ir.call("mul", _c("b"), ir.call(
            "if", ir.call("gt", _p("d"), _p("h")), _p("k"), _p("s", F64)))),
        ir.Assign("x4", ir.call("add", _c("pa"), ir.call(
            "add", _p("d"), _p("k")))),
        ir.Assign("x5", ir.call("sub", _c("a"), ir.call(
            "idiv", _p("lim"), ir.call("add", _p("d"), _p("h"))))),
        ir.Filter(ir.call("le", _c("x4"), ir.call("add", _p("d"),
                                                   _p("lim"))))),
    # bare columns alone: nothing to compute
    "aliases": (
        ir.Assign("a2", _c("a")), ir.Assign("pa2", _c("pa")),
        ir.Assign("b2", _c("b"))),
}
SELS = ("none", "shared", "member")


def _sel(kind, masks):
    return {"none": None, "shared": masks[0].clone(),
            "member": masks}[kind]


def _bits(t):
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _equal(got, want, what):
    assert (got is None) == (want is None), what
    if want is None:
        return
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape,
                                                   want.shape)
    if want.dtype.is_floating_point:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), what
        got, want = got[~nan], want[~nan]
    assert torch.equal(_bits(got), _bits(want)), what


def _run_both(stage, env, params, sel, n, launcher):
    e1, e2 = dict(env), dict(env)
    s1 = k1.run_stage_plain(stage, e1, params, sel, n, CPU)
    s2 = k1.run_stage_compiled(stage, e2, params, sel, n, CPU, launcher)
    for c in stage:
        if isinstance(c, ir.Assign):
            _equal(e2[c.name][0], e1[c.name][0], f"{c.name} data")
            _equal(e2[c.name][1], e1[c.name][1], f"{c.name} validity")
    _equal(s2, s1, "selection")
    return e2, s2


def _cases():
    for B in MEMBERS:
        for name in STAGES:
            for sel in SELS:
                yield B, name, sel


@pytest.fixture(scope="module")
def built(host):
    """Every case's source, compiled in parallel up front."""
    rec = Recorder()
    for B, name, sel in _cases():
        for n in (N, 0):
            env, params, masks = _inputs(B, n)
            k1.run_stage_compiled(STAGES[name], dict(env), params,
                                  _sel(sel, masks), n, CPU, rec)
    host.prebuild(rec.progs)
    return host


# --------------------------------------------------------------------------
# host-compiled stages against the plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sel", SELS)
@pytest.mark.parametrize("name", sorted(STAGES))
@pytest.mark.parametrize("B", MEMBERS)
def test_member_stage_equals_plain(built, B, name, sel):
    env, params, masks = _inputs(B, N)
    before = len(built.members)
    sel_in = _sel(sel, masks)
    e2, s2 = _run_both(STAGES[name], env, params, sel_in, N, built)
    launched = built.members[before:]
    if name == "aliases":
        assert launched == [] and s2 is sel_in
        for c in STAGES[name]:
            assert e2[c.name] is env[c.expr.name]
        return
    assert len(launched) == 1
    # the member count reaches the kernel only when an output has the
    # member axis
    per_member = any(t is not None and t.dim() == 2
                     for c in STAGES[name] if isinstance(c, ir.Assign)
                     for t in e2[c.name]) or (s2 is not None
                                              and s2.dim() == 2)
    assert launched[0] == (B if per_member else 1)


@pytest.mark.parametrize("sel", SELS)
@pytest.mark.parametrize("name", sorted(STAGES))
@pytest.mark.parametrize("B", [1, 3, 33])
def test_member_stage_at_zero_rows(built, B, name, sel):
    env, params, masks = _inputs(B, 0)
    before = len(built.members)
    _run_both(STAGES[name], env, params, _sel(sel, masks), 0, built)
    assert built.members[before:] == []       # nothing to launch


# --------------------------------------------------------------------------
# the source's structure
# --------------------------------------------------------------------------


def _program(name, B, sel="none"):
    env, params, masks = _inputs(B, N)
    rec = Recorder()
    k1.run_stage_compiled(STAGES[name], dict(env), params,
                          _sel(sel, masks), N, CPU, rec)
    (prog,) = rec.progs
    return prog


def _body(src: str, fn: str) -> list:
    body = src[src.index(f"K1_DEV void {fn}("):]
    body = body[body.index("{") + 1:body.index("\n}\n")]
    return [ln.strip() for ln in body.splitlines() if ln.strip()]


def test_shared_columns_load_once_before_the_member_loop():
    prog = _program("mixed", 8, "member")
    lines = _body(prog.source, "k1_row")
    assert LOOP in lines
    loop = lines.index(LOOP)
    before, inside = lines[:loop], lines[loop + 1:]
    decl = prog.source[prog.source.index("K1_DEV void k1_row("):]
    decl = decl[:decl.index("{")]
    shared, member = [], []
    for m in re.finditer(r"const (k1_\w+)\* __restrict__ (c\d+v?)\b", decl):
        ptr = m.group(2)
        ms = re.search(rf"\b{ptr}_ms\b", decl) is not None
        (member if ms else shared).append(ptr)
    assert shared and member
    text_before, text_inside = "\n".join(before), "\n".join(inside)
    for ptr in shared:
        loads = re.findall(rf"\b{ptr}\[", prog.source)
        assert len(loads) == 1, (ptr, loads)
        assert f"{ptr}[i]" in text_before and f"{ptr}[" not in text_inside
    for ptr in member:
        assert f"{ptr}[m * {ptr}_ms + i]" in text_inside
        assert f"{ptr}[" not in text_before
    # a member's (B,) params, and their conversions, once a member for
    # the block (k1_members, into shared memory), read back in the loop;
    # a (B, L) LUT gathered in the loop; nothing of a member before it
    members = "\n".join(_body(prog.source, "k1_members"))
    params = re.findall(r"= (p\d+)\[m\];", members)
    assert len(params) == 3, members            # k, s and lim
    # an int64 member param against a float64 column: converted there
    assert re.search(r"= \(\(k1_f64\)v\d+\);", members), members
    assert not re.search(r"\bp\d+\[m\]", text_inside)
    kept = re.findall(r"(s\d+)\[m\] = ", members)
    for a in kept:
        assert re.search(rf"= {a}\[m\];", text_inside)
    assert re.search(r"p\d+\[m \* p\d+_ms \+ v\d+\]", text_inside)
    assert not re.search(r"\[m\]", text_before)
    assert "extern __shared__ k1_u64 k1_sm[];" in prog.source
    assert "__syncthreads();" in prog.source
    assert prog.smem_per_member == 8 * len(kept)
    # shared outputs once, outside; per-member ones inside; no member-0
    # store left
    assert "if (m == 0)" not in prog.source
    for k, o in enumerate(prog.outs):
        if o is None:
            continue
        where = text_inside if o.pm else text_before
        assert f"o{k}[{'m * n + i' if o.pm else 'i'}] = " in where, o
    assert "s_out[m * n + i] = " in text_inside
    # the kernel: 1-D, n and members last; the host entry loops over rows
    assert re.search(r"k1_stage\([^)]*const k1_i64 n, const k1_i64 members\)",
                     prog.source)
    assert "blockIdx.y" not in prog.source
    assert "for (k1_i64 i = 0; i < n; ++i) k1_row(i, " in prog.source
    assert prog.member_loop


@pytest.mark.parametrize("name", ["mixed", "member_consts"])
def test_member_values_declare_what_they_read(name):
    """k1_members computes a member's values from every line that does
    not read the row, in order: each value it reads is declared there
    first (a constant divisor, a guarded one, a shared condition, a 0-d
    tensor's load), and none reads the row."""
    prog = _program(name, 8, "member")
    declared = set()
    for ln in _body(prog.source, "k1_members"):
        d = re.match(r"const k1_\w+ (v\d+) = (.*);$", ln)
        expr = d.group(2) if d else ln
        for w in re.findall(r"\b(v\d+|i)\b", expr):
            assert w in declared, (w, ln)
        if d:
            declared.add(d.group(1))
    assert declared


def test_a_stage_without_member_outputs_has_no_loop():
    for B in (1, 8):
        prog = _program("shared_only", B, "none")
        assert LOOP not in prog.source and not prog.member_loop
    prog = _program("pm_filter", 1, "shared")
    assert LOOP in prog.source          # a (B,) param: B = 1 still loops


def test_filter_connectives_are_two_valued():
    """A Filter keeps the rows whose predicate is TRUE: through `and` /
    `or` that is two-valued, so no Kleene pair rides its connectives
    (the host-compiled cases above hold it bit for bit)."""
    for B in (1, 8):
        prog = _program("kleene_filter", B, "member")
        assert "k1_kleene_" not in prog.source.split(
            "// ---- generated stage ----")[1]
    # an Assign of the same predicate keeps its validity
    env, params, masks = _inputs(8, N)
    rec = Recorder()
    stage = (ir.Assign("k", STAGES["kleene_filter"][0].pred),)
    k1.run_stage_compiled(stage, dict(env), params, None, N, CPU, rec)
    assert "k1_kleene_or_v(" in rec.progs[0].source


def test_a_shared_output_never_reads_the_member():
    """The generator refuses to store a value that reads the member
    index into an output without the member axis."""
    g = k1._Gen({}, {}, torch.get_default_dtype())
    v = g.var(torch.int64, "p0[m]")
    w = g.var(torch.int64, f"k1_add({v}, c0[i])")
    assert g.member(w) and not g.member("c0[i]")
    assert not g.member("k1_add(c0_ms, members)")


# --------------------------------------------------------------------------
# the batched answers against the JAX engine's batched lane
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_engines():
    from ydb_tpu.bench.tpch_gen import load_tpch as jax_load_tpch
    from ydb_tpu_torch.bench import tpch_gen as port_gen
    je = JaxEngine(block_rows=1 << 13)
    jax_load_tpch(je.catalog, sf=0.01, shards=2, portion_rows=1 << 13)
    pe = PortEngine(device="cpu", block_rows=1 << 13)
    port_gen.load_tpch(pe.catalog, sf=0.01, shards=2, portion_rows=1 << 13)
    return je, pe


def _batched(eng, parse, texts):
    plans = [eng.planner.plan_select(parse(q)) for q in texts]
    pipe = plans[0].pipeline
    p0 = dataclasses.replace(plans[0], pipeline=dataclasses.replace(
        pipe, scan=dataclasses.replace(pipe.scan, prune=[])))
    return eng.executor.execute_fused_batched(
        p0, [(p, dict(p.params)) for p in plans], eng.snapshot())


@pytest.mark.parametrize("name,B", [("q19", 8), ("point", 8),
                                    ("point", 33)])
def test_batched_answers_through_the_compiled_stages(
        tpch_engines, host, monkeypatch, name, B):
    je, pe = tpch_engines
    if name == "point":
        keys = pe.query("select o_orderkey from orders")["o_orderkey"]
        texts = serving.point_variants(np.asarray(keys), B, seed=7)
    else:
        texts = serving.variants(name, B, seed=7)
    assert len(set(texts)) == B
    before = len(host.members)
    monkeypatch.setattr(k1, "run_stage", lambda st, env, params, sel, cap,
                        device: k1.run_stage_compiled(
                            st, env, params, sel, cap, device, host))
    got = _batched(pe, port_parse, texts)
    want = _batched(je, jax_parse, texts)
    assert got is not None and want is not None
    for g, w, q in zip(got, want, texts):
        gf, wf = g.to_pandas(), w.to_pandas()
        assert list(gf.columns) == list(wf.columns), q
        assert_frames_match(gf, wf, ordered=True)
    # the batch's stages ran compiled, one launch looping over B members
    assert B in host.members[before:], host.members[before:]
