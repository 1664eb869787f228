"""K1 (``ydb_tpu_torch/ops/k1.py``): each Assign/Filter stage as one
generated kernel, held on the CPU.

- (a) Every op of ``ops/kernels.py`` over each storage dtype it takes,
  with and without NULLs (``bench/k1_sweep.py``, seeded): the port's
  ``k1.run_stage`` (on CPU tensors, the plain version) equals the
  reference's ``xla_exec._eval`` run by JAX on the CPU. Ints, bools and
  masks exactly; float64 results to rtol 1e-9. A float32 result is held
  at float32's precision (rtol 1e-6; XLA flushes float32 denormals to
  zero): where torch's promotion gives float32 and the reference float64
  (an int under sqrt, exp, ln or round takes torch's default float),
  the dtype pair is asserted too.
- (b) Every stage the TPC-H (SF 0.01), TPC-DS (SF 0.01) and ClickBench
  (20,000 rows) plans produce: the generator's storage dtype, validity
  presence and member axis of each output equal the plain version's.
- (c) The member axis: shared and ``PerMember`` scalars and (B, L)
  LUTs, held against B single runs.
- (d) The generated source of each of those stages and of the sweep,
  compiled by the host's ``g++`` (``-O2 -ffp-contract=off``: the row
  function and the prelude, no ``__global__``) into a shared library
  driven through ctypes over the tensors' memory, equals the plain
  version: bit for bit (any NaN for any NaN), except exp, ln and pow (rtol 1e-12 in float64,
  one float32 ulp in float32: libm and torch's vector math may differ
  by an ulp).
- (e) Every ``KERNELS`` name has an emitter, and the sweep reaches each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ydb_tpu.core import dtypes as jdt
from ydb_tpu.ops import ir as jir, xla_exec

from ydb_tpu_torch.bench import k1_sweep
from ydb_tpu_torch.ops import ir, k1
from ydb_tpu_torch.ops.kernels import KERNELS
from ydb_tpu_torch.ops.torch_exec import PerMember
from tests import torch_threads  # noqa: F401,E402

N = 257
SEED = 20261017
RTOL = 1e-9
F32_RTOL = 1e-6                  # a float32 result: float32's precision
CPU = torch.device("cpu")
_TRANSCENDENTAL = ("exp", "ln", "pow")


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _env(cols, n=None):
    out = {}
    for k, (d, v) in cols.items():
        d = d if n is None else d[:n]
        v = v if v is None or n is None else v[:n]
        out[k] = (torch.from_numpy(np.ascontiguousarray(d)),
                  None if v is None else torch.from_numpy(
                      np.ascontiguousarray(v)))
    return out


def _params(prm):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in prm.items()}


def _supported(expr, cols, prm) -> bool:
    return k1.supports((ir.Assign("r", expr),), _env(cols, 1), _params(prm))


CASES = k1_sweep.cases(N, SEED, supported=_supported)


def _to_ref(e):
    """A port expression as the reference's IR."""
    if isinstance(e, ir.Col):
        return jir.Col(e.name)
    if isinstance(e, ir.Const):
        return jir.Const(e.value, jdt.DType(jdt.Kind(e.dtype.kind.value),
                                            e.dtype.nullable))
    if isinstance(e, ir.Param):
        return jir.Param(e.name, jdt.DType(jdt.Kind(e.dtype.kind.value),
                                           e.dtype.nullable), e.is_array)
    return jir.Call(e.op, tuple(_to_ref(a) for a in e.args), e.extra)


class HostLauncher:
    """Runs a generated stage's source compiled by the host's g++: the
    prelude and the row function, driven by the source's host loop."""

    def __init__(self, workdir):
        self.dir = str(workdir)
        self.fns = {}

    @staticmethod
    def _digest(prog) -> str:
        return hashlib.sha1(prog.source.encode()).hexdigest()[:20]

    def _compile(self, prog) -> str:
        h = self._digest(prog)
        so = os.path.join(self.dir, f"lib{h}.so")
        if not os.path.exists(so):
            src = os.path.join(self.dir, f"{h}.cc")
            with open(src, "w") as f:
                f.write(prog.source)
            subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared",
                            "-fPIC", "-o", so + ".tmp", src], check=True,
                           capture_output=True, text=True)
            os.replace(so + ".tmp", so)
        return so

    def prebuild(self, progs) -> None:
        todo = {self._digest(p): p for p in progs}
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(self._compile, todo.values()))

    def launch(self, prog, args, n, grid_y, device) -> None:
        h = self._digest(prog)
        fn = self.fns.get(h)
        if fn is None:
            fn = self.fns[h] = ctypes.CDLL(self._compile(prog)).k1_host
            fn.restype = None
        fn(*args, ctypes.c_int64(n), ctypes.c_int64(grid_y))


class Recorder:
    """A launcher that only records the programs (a dry run, to build
    every source before the real runs)."""

    def __init__(self):
        self.progs = []

    def launch(self, prog, args, n, grid_y, device) -> None:
        self.progs.append(prog)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return HostLauncher(tmp_path_factory.mktemp("k1_host"))


def _clone_env(env):
    return {k: (d, v) for k, (d, v) in env.items()}


def _run_both(stage, env, params, sel, cap, launcher):
    """(plain env, plain sel), (compiled env, compiled sel)."""
    e1 = _clone_env(env)
    s1 = k1.run_stage_plain(stage, e1, params, sel, cap, CPU)
    e2 = _clone_env(env)
    s2 = k1.run_stage_compiled(stage, e2, params, sel, cap, CPU, launcher)
    return (e1, s1), (e2, s2)


def _same_meta(a, b, what):
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert tuple(a.shape) == tuple(b.shape), \
        f"{what}: shape {tuple(a.shape)} vs {tuple(b.shape)}"


def _bits_equal(got, want, what, rtol=0.0):
    _same_meta(got, want, what)
    if got.dtype.is_floating_point and rtol:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                   atol=0, equal_nan=True, err_msg=what)
        return
    g, w = got.numpy(), want.numpy()
    if g.dtype.kind == "f":
        # bit for bit (-0.0 is not 0.0), any NaN for any NaN: a NaN's
        # payload is not part of the answer
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=what)
        g = g[~nan].view(np.int32 if g.itemsize == 4 else np.int64)
        w = w[~nan].view(np.int32 if w.itemsize == 4 else np.int64)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _uses(stage, ops) -> bool:
    found = []

    def walk(e):
        if isinstance(e, ir.Call):
            if e.op in ops:
                found.append(e.op)
            for a in e.args:
                walk(a)

    for c in stage:
        walk(c.expr if isinstance(c, ir.Assign) else c.pred)
    return bool(found)


def _float32_ulp(stage, env) -> bool:
    return any(isinstance(c, ir.Assign) and env[c.name][0].dtype
               == torch.float32 for c in stage)


def _assert_envs_equal(stage, plain, compiled, label):
    (e1, s1), (e2, s2) = plain, compiled
    tol = 0.0
    if _uses(stage, _TRANSCENDENTAL):
        tol = 2e-7 if _float32_ulp(stage, e1) else 1e-12
    for c in stage:
        if not isinstance(c, ir.Assign):
            continue
        (d1, v1), (d2, v2) = e1[c.name], e2[c.name]
        _bits_equal(d2, d1, f"{label} {c.name} data", tol)
        assert (v1 is None) == (v2 is None), f"{label} {c.name} validity"
        if v1 is not None:
            _bits_equal(v2, v1, f"{label} {c.name} validity")
    assert (s1 is None) == (s2 is None), f"{label}: selection"
    if s1 is not None:
        _bits_equal(s2, s1, f"{label}: selection")


def _prebuild(host, runs):
    """Dry-run every (stage, env, params, sel, cap), then compile all
    their sources in parallel."""
    rec = Recorder()
    for stage, env, params, sel, cap in runs:
        k1.run_stage_compiled(stage, _clone_env(env), params, sel, cap, CPU,
                              rec)
    host.prebuild(rec.progs)


# --------------------------------------------------------------------------
# (e) coverage
# --------------------------------------------------------------------------


def test_every_kernel_has_an_emitter():
    missing = [name for name in KERNELS if name not in k1.EMITTERS]
    assert not missing, f"ops without a K1 emitter: {missing}"
    assert set(k1.EMITTERS) == set(KERNELS)


def test_the_sweep_reaches_every_op():
    ops = set()

    def walk(e):
        if isinstance(e, ir.Call):
            ops.add(e.op)
            for a in e.args:
                walk(a)

    for case in CASES:
        for c in case.stage:
            walk(c.expr)
    assert ops == set(KERNELS), sorted(set(KERNELS) - ops)


def test_an_op_without_emitter_raises():
    stage = (ir.Assign("r", ir.Call("no_such_op", (ir.Col("a"),))),)
    env = {"a": (torch.zeros(4, dtype=torch.int64), None)}
    with pytest.raises(k1.Unsupported):
        k1.run_stage_compiled(stage, env, {}, None, 4, CPU, Recorder())


# --------------------------------------------------------------------------
# (a) the sweep against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_op_sweep_matches_reference(case):
    env, params = _env(case.cols), _params(case.params)
    sel = k1.run_stage(case.stage, env, params, None, N, CPU)
    assert sel is None
    jenv = {k: (jnp.asarray(d), None if v is None else jnp.asarray(v))
            for k, (d, v) in case.cols.items()}
    jparams = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in case.params.items()}
    for c in case.stage:
        d, v = env[c.name]
        if not case.jax:
            continue
        jd, jv = xla_exec._eval(_to_ref(c.expr), jenv, jparams, N)
        jd, jv = np.asarray(jd), None if jv is None else np.asarray(jv)
        assert (v is None) == (jv is None), f"{c.name}: validity presence"
        valid = np.ones(N, bool) if jv is None else jv
        if jv is not None:
            np.testing.assert_array_equal(v.numpy(), jv, err_msg=c.name)
        got = d.numpy()
        if jd.dtype == np.uint64:
            jd = jd.view(np.int64)
        if jd.dtype.kind == "f" or got.dtype.kind == "f":
            rtol, atol = RTOL, np.finfo(np.float64).tiny
            if got.dtype != jd.dtype:
                # torch's default float against the reference's float64
                assert (got.dtype, jd.dtype) == (np.float32, np.float64), \
                    (c.name, got.dtype, jd.dtype)
            if np.float32 in (got.dtype, jd.dtype):
                # float32 precision; XLA flushes float32 denormals to 0
                rtol, atol = F32_RTOL, np.finfo(np.float32).tiny
            np.testing.assert_allclose(got[valid].astype(np.float64),
                                       jd[valid].astype(np.float64),
                                       rtol=rtol, atol=atol, equal_nan=True,
                                       err_msg=c.name)
        else:
            assert got.dtype == jd.dtype, (c.name, got.dtype, jd.dtype)
            np.testing.assert_array_equal(got[valid], jd[valid],
                                          err_msg=c.name)


# --------------------------------------------------------------------------
# (d) the sweep's generated source, host-compiled, against the plain version
# --------------------------------------------------------------------------


def _sweep_runs():
    runs = []
    for case in CASES:
        runs.append((case.name, case.stage, _env(case.cols),
                     _params(case.params), None, N))
    cols, prm = k1_sweep.columns(N, SEED), _params(k1_sweep.params(SEED))
    env = _env(cols)
    mask = torch.from_numpy(np.random.default_rng(SEED).random(N) < 0.6)
    for nf in (1, 2):
        stage = k1_sweep.filter_stage(nf)
        runs.append((f"filters {nf}", stage, env, prm, None, N))
        runs.append((f"filters {nf} after a mask", stage, env, prm, mask, N))
    # zero rows
    for case in CASES[:3]:
        runs.append((f"{case.name} at 0 rows", case.stage,
                     _env(case.cols, 0), _params(case.params), None, 0))
    return runs


def test_op_sweep_host_compiled_matches_plain(host):
    runs = _sweep_runs()
    _prebuild(host, [r[1:] for r in runs])
    for label, stage, env, params, sel, cap in runs:
        plain, compiled = _run_both(stage, env, params, sel, cap, host)
        _assert_envs_equal(stage, plain, compiled, label)


def test_cuda_tensors_never_take_the_plain_version():
    """Asked for CUDA, K1 checks its inputs for the launch and raises on
    CPU tensors; it never runs the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    case = CASES[0]
    with pytest.raises(ValueError, match="expected cuda"):
        k1.run_stage(case.stage, _env(case.cols), _params(case.params), None,
                     N, "cuda")


# --------------------------------------------------------------------------
# (c) the member axis
# --------------------------------------------------------------------------

B = 3


def _member_stage():
    from ydb_tpu_torch.core.dtypes import DType, Kind
    i64, f64 = DType(Kind.INT64), DType(Kind.FLOAT64)
    lut = ir.Param("lut", DType(Kind.INT32), is_array=True)
    return (
        ir.Assign("a", ir.call("add", ir.Col("x_int64"), ir.Param("k", i64))),
        ir.Assign("b", ir.call("mul", ir.Col("y_float64"),
                               ir.Param("s", f64))),
        ir.Filter(ir.call("lt", ir.Col("a"), ir.Param("lim", i64))),
        ir.Assign("c", ir.call("take_lut", ir.Col("codesn"), lut,
                               null_neg=True)),
        ir.Assign("d", ir.call("if", ir.Col("cond"), ir.Col("a"),
                               ir.Col("b"))),
        ir.Filter(ir.call("not", ir.call("is_null", ir.Col("c")))))


def _member_params(rng):
    return {"k": rng.integers(-50, 50, B), "s": rng.normal(size=B),
            "lim": rng.integers(0, 200_000, B),
            "lut": rng.integers(-3, 50, (B, k1_sweep.LUT_LEN)
                                ).astype(np.int32)}


@pytest.mark.parametrize("shared", ["k", "s", "lut", "none"])
@pytest.mark.parametrize("member_sel", [False, True])
def test_member_axis_matches_single_runs(host, shared, member_sel):
    rng = np.random.default_rng(SEED + 7)
    cols = k1_sweep.columns(N, SEED)
    env = _env(cols)
    stage = _member_stage()
    pm = _member_params(rng)
    batched = {}
    for k, v in pm.items():
        batched[k] = (torch.from_numpy(v[0]) if k == "lut" else v[0].item()) \
            if k == shared else PerMember(torch.from_numpy(v))
    masks = torch.from_numpy(rng.random((B, N)) < 0.7)
    sel = masks if member_sel else masks[0].clone()
    _prebuild(host, [(stage, env, batched, sel, N)])
    plain, compiled = _run_both(stage, env, batched, sel, N, host)
    _assert_envs_equal(stage, plain, compiled, f"B={B}")
    e2, s2 = compiled
    assert s2.shape == (B, N)
    for b in range(B):
        single = {k: ((torch.from_numpy(v[0 if k == shared else b])
                       if k == "lut" else v[0 if k == shared else b].item()))
                  for k, v in pm.items()}
        es = _clone_env(env)
        ss = k1.run_stage_plain(stage, es, single, sel[b] if member_sel
                                else sel, N, CPU)
        np.testing.assert_array_equal(s2[b].numpy(), ss.numpy())
        for c in stage:
            if not isinstance(c, ir.Assign):
                continue
            (d2, v2), (ds, vs) = e2[c.name], es[c.name]
            row = d2[b] if d2.dim() == 2 else d2
            _bits_equal(row, ds, f"member {b} {c.name}")
            if vs is not None:
                vrow = v2[b] if v2.dim() == 2 else v2
                _bits_equal(vrow, vs, f"member {b} {c.name} validity")
    # a value is per member only where it depends on one
    assert (e2["a"][0].dim() == 2) == (shared != "k")
    assert (e2["b"][0].dim() == 2) == (shared != "s")
    assert (e2["c"][0].dim() == 2) == (shared != "lut")


# --------------------------------------------------------------------------
# (b) and (d): every stage the suites' plans produce
# --------------------------------------------------------------------------


def _suite_engine(suite):
    from ydb_tpu_torch.bench import clickbench_gen, tpcds_gen, tpch_gen
    from ydb_tpu_torch.query import QueryEngine
    eng = QueryEngine(device="cpu", block_rows=1 << 13)
    if suite == "tpch":
        tpch_gen.load_tpch(eng.catalog, sf=0.01, shards=2,
                           portion_rows=1 << 13)
        from tests.tpch_util import QUERIES
    elif suite == "tpcds":
        tpcds_gen.load_tpcds(eng.catalog, sf=0.01, shards=2,
                             portion_rows=1 << 12)
        from tests.tpcds_util import QUERIES
    else:
        clickbench_gen.load_hits(eng.catalog, n_rows=20_000, shards=2,
                                 portion_rows=1 << 12)
        from tests.clickbench_util import QUERIES
    return eng, QUERIES


@pytest.fixture(scope="module", params=["tpch", "tpcds", "clickbench"])
def suite_stages(request, monkeypatch_module):
    """Each distinct (stage, input signature) the suite's queries run,
    with the inputs of its first run (late materialization on and off
    for TPC-H)."""
    eng, queries = _suite_engine(request.param)
    seen = {}
    real = k1.run_stage

    def record(stage, env, params, sel, cap, device):
        key = k1.stage_key(stage)
        names = set()
        for c in stage:
            ir.expr_columns(c.expr if isinstance(c, ir.Assign) else c.pred,
                            names)
        sig = tuple((n, tuple(None if t is None else (t.dtype, t.dim())
                              for t in env[n])) for n in sorted(names)
                    if n in env) + (None if sel is None else sel.dim(),)
        if (key, sig) not in seen:
            seen[(key, sig)] = (tuple(stage), _clone_env(env), dict(params),
                                sel, cap)
        return real(stage, env, params, sel, cap, device)

    monkeypatch_module.setattr(k1, "run_stage", record)
    for late in (("1", "0") if request.param == "tpch" else ("1",)):
        monkeypatch_module.setenv("YDB_TPU_LATE_MAT", late)
        for sql in queries.values():
            eng.query(sql)
    monkeypatch_module.setattr(k1, "run_stage", real)
    assert seen
    return request.param, list(seen.values())


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_suite_stage_types_match_plain(suite_stages):
    """(b): dtype, validity presence and member axis of every output."""
    suite, stages = suite_stages
    for stage, env, params, sel, cap in stages:
        e1 = _clone_env(env)
        s1 = k1.run_stage_plain(stage, e1, params, sel, cap, CPU)
        e2 = _clone_env(env)
        s2 = k1.run_stage_compiled(stage, e2, params, sel, cap, CPU,
                                   Recorder())
        for c in stage:
            if isinstance(c, ir.Assign):
                (d1, v1), (d2, v2) = e1[c.name], e2[c.name]
                _same_meta(d2, d1, f"{suite} {c!r}")
                assert (v1 is None) == (v2 is None), f"{suite} {c!r}"
                if v1 is not None:
                    _same_meta(v2, v1, f"{suite} {c!r} validity")
        assert (s1 is None) == (s2 is None)
        if s1 is not None:
            _same_meta(s2, s1, f"{suite} selection")


def test_suite_stage_sources_on_host_match_plain(suite_stages, host):
    """(d): every stage's generated source, compiled by g++."""
    suite, stages = suite_stages
    _prebuild(host, stages)
    for stage, env, params, sel, cap in stages:
        plain, compiled = _run_both(stage, env, params, sel, cap, host)
        _assert_envs_equal(stage, plain, compiled, suite)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------


def test_programs_run_their_stages_through_k1(monkeypatch):
    """`_trace_program` hands each maximal Assign/Filter run to
    `k1.run_stage` as one stage."""
    from ydb_tpu_torch.core.dtypes import DType, Kind
    from ydb_tpu_torch.core.schema import Column
    from ydb_tpu_torch.ops import torch_exec
    calls = []
    real = k1.run_stage
    monkeypatch.setattr(k1, "run_stage", lambda st, *a: calls.append(
        [type(c).__name__ for c in st]) or real(st, *a))
    i64 = DType(Kind.INT64)
    prog = ir.Program()
    prog.assign("b", ir.call("add", ir.Col("a"), ir.Const(1, i64)))
    prog.filter(ir.call("gt", ir.Col("b"), ir.Const(3, i64)))
    prog.assign("c", ir.call("mul", ir.Col("b"), ir.Col("b")))
    prog.group_by([], [ir.Agg("s", "sum", "c")])
    prog.assign("t", ir.call("add", ir.Col("s"), ir.Const(1, i64)))
    env = {"a": (torch.arange(8, dtype=torch.int64), None)}
    env, _len, _sel, _schema = torch_exec._trace_program(
        prog, [Column("a", i64)], 8, env, torch.tensor(8), {}, CPU)
    assert calls == [["Assign", "Filter", "Assign"], ["Assign"]]
    assert int(env["t"][0][0]) == sum(b * b for b in range(1, 9) if b > 3) + 1
