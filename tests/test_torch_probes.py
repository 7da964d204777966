"""The plain versions of the two probe kernels, K5f (op_probe) and K5i
(bcast_probe), against the TPU scripts' Pallas kernels run in interpret
mode on the CPU, on the same numpy inputs.

``scripts/ablations/tune_r2f.py`` is loaded from its file; its nine
expressions live in ``main`` and are read from there with ``ast``, so the
test runs the script's own lambdas. ``tune_r4d_bcast_probe.py`` runs its
whole sweep (REPS = 2048) at module level, so it cannot be imported: the
test executes only its imports, assignments and function definitions,
with REPS set to 2. Neither script is edited.
"""

import ast
import functools
import importlib.util
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import rel_err

from nbody_tpu_torch.ablations import tune_r2f, tune_r4d_bcast_probe
from nbody_tpu_torch.ops import bcast_probe as bp
from nbody_tpu_torch.ops import op_probe as op

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts" / "ablations"
# K5f, max|d|/max|ref| after 3-5 loops. add and mul are one IEEE operation
# on both sides: bit-equal. recip_apx: pl.reciprocal(approx=True) is a
# coarse approximation in interpret mode (measured 3.55e-3 of max|ref|
# after 5 loops); the port's plain version is 1 / a. The rest are the
# same fp32 operations, in XLA's and PyTorch's CPU kernels (measured at
# most 1.2e-6, sq_chain's squares of b up to 4).
K5F_TOL = {"add": 0.0, "mul": 0.0, "recip_apx": 5e-3}
K5F_DEFAULT_TOL = 5e-6
# K5i, over the finite entries: two sweeps of the same direct sum, summed
# in another order (the script's 128 lane partials): the direct force's
# bound.
K5I_TOL = 5e-6


@pytest.fixture
def interpret(monkeypatch):
    """Pallas kernels run in interpret mode while the test runs."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


@functools.cache
def _k5f():
    """(the script module, {name: expression}) from tune_r2f.py."""
    path = SCRIPTS / "tune_r2f.py"
    spec = importlib.util.spec_from_file_location("_ablation_tune_r2f", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    main = next(n for n in ast.parse(path.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    probes = next(n.value for n in main.body if isinstance(n, ast.Assign)
                  and n.targets[0].id == "probes")
    return mod, eval(compile(ast.Expression(probes), str(path), "eval"),
                     vars(mod))


@functools.cache
def _k5i(reps=2):
    """tune_r4d_bcast_probe.py's imports, assignments and functions, with
    REPS = reps; its module-level sweep is left out."""
    path = SCRIPTS / "tune_r4d_bcast_probe.py"
    tree = ast.parse(path.read_text())
    keep = (ast.Import, ast.ImportFrom, ast.Assign, ast.FunctionDef)
    tree.body = [n for n in tree.body if isinstance(n, keep)]
    ns = {"__name__": "_ablation_tune_r4d_bcast_probe"}
    exec(compile(tree, str(path), "exec"), ns)
    ns["REPS"] = reps
    return ns


def test_k5f_script_has_the_ports_expressions():
    _, probes = _k5f()
    assert tuple(probes) == op.EXPRS


@pytest.mark.parametrize("loops", [3, 4, 5])
@pytest.mark.parametrize("expr", op.EXPRS)
def test_k5f_plain_matches_script(interpret, expr, loops):
    mod, probes = _k5f()
    x, y = tune_r2f.inputs(expr, "cpu")
    assert tuple(x.shape) == (mod.TT, mod.CC)
    want = np.asarray(mod.make_probe(probes[expr], loops)(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    got = op.op_probe(x, y, expr=expr, loops=loops)
    fin = np.isfinite(want)
    assert fin.all() and torch.isfinite(got).all()
    tol = K5F_TOL.get(expr, K5F_DEFAULT_TOL)
    if tol == 0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert rel_err(got, want) < tol


def test_k5f_recip_apx_is_coarse_in_interpret_mode(interpret):
    """The script's approximate reciprocal in interpret mode is off by more
    than the other expressions' rounding, hence its own tolerance."""
    mod, probes = _k5f()
    x, y = tune_r2f.inputs("recip_apx", "cpu")
    want = np.asarray(mod.make_probe(probes["recip_apx"], 5)(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    assert rel_err(op.op_probe(x, y, expr="recip_apx", loops=5), want) > 1e-4


def test_k5i_script_loads_without_its_sweep():
    ns = _k5i()
    assert ns["REPS"] == 2 and (ns["T"], ns["S"]) == (tune_r4d_bcast_probe.T,
                                                       tune_r4d_bcast_probe.S)
    assert "ref" in ns and ns["ref"] is None   # the sweep's loop never ran


@pytest.mark.parametrize("abs_row2", [False, True])
@pytest.mark.parametrize("variant", ["mixed", "bcast", "onesmul", "arrslice"])
def test_k5i_plain_matches_script(interpret, variant, abs_row2):
    """The script's inputs: NaN at the same entries (246 of 512 targets
    when the third row keeps its sign, none with |row 2|), the finite
    entries within 5e-6."""
    ns = _k5i()
    tgt, src = tune_r4d_bcast_probe.inputs("cpu", abs_row2)
    np.testing.assert_array_equal(np.asarray(ns["tgt"])[:2], tgt[:2].numpy())
    want = np.asarray(ns["run"](jnp.asarray(tgt.numpy()),
                                jnp.asarray(src.numpy()), variant=variant))
    got = bp.bcast_acc(tgt, src, reps=ns["REPS"]).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert (~fin).any(axis=0).sum() == (0 if abs_row2 else 246)
    assert rel_err(got[fin], want[fin]) < K5I_TOL


@pytest.mark.parametrize("reps,n_split", [(2, 1), (5, 2), (7, 3), (0, 1)])
def test_k5i_plain_is_reps_sweeps(reps, n_split):
    """Any split of the sweeps gives reps times one sweep, up to the fp32
    rounding of the repeated adds; two sweeps exactly twice one."""
    tgt, src = (t[:, :64] for t in tune_r4d_bcast_probe.inputs("cpu", True))
    sweep = bp.sweep_plain(tgt, src)
    got = bp.bcast_acc_plain(tgt, src, reps=reps, n_split=n_split)
    if reps <= 2:
        assert torch.equal(got, reps * sweep)
    else:
        assert rel_err(got, reps * sweep) < 1e-6


@pytest.mark.parametrize("t,blocks", [(1, 1), (300, 1), (512, 1), (513, 2),
                                      (1100, 3)])
@pytest.mark.parametrize("reps,sms", [(2048, 132), (5, 132), (2048, 78)])
def test_k5i_split_plan_counts_blocks_of_two_targets_a_thread(t, blocks, reps, sms):
    """A block holds P = 2 targets a thread, P * 256 in all: the script's
    T = 512 is one block, and the sweeps are split to fill the card from
    it (256 ranges of 8 sweeps on 132 SMs)."""
    from nbody_tpu_torch.ops.direct_forces import split_ranges

    assert bp.P * bp.THREADS == 512
    assert bp.split_plan(t, reps, sms) == split_ranges(blocks, reps, sms)
    assert bp.split_plan(512, 2048, 132) == 256


def test_k5i_counts_pairs_where_the_ftz_rsqrt_differs():
    """``subnormal_pairs`` counts 0 < r2 < FLT_MIN: none on either input
    set at the script's shape (where the ftz rsqrt and rsqrtf agree), one
    where a target with a subnormal third row sits on a source."""
    for abs_row2 in (False, True):
        count, least = bp.subnormal_pairs(*tune_r4d_bcast_probe.inputs(
            "cpu", abs_row2))
        assert count == 0 and least >= torch.finfo(torch.float32).tiny
    tgt = torch.tensor([[0.5, 2.0], [0.5, 0.0], [1e-39, 1.0]])
    src = torch.tensor([[0.5, 4.0], [0.5, 4.0], [1.0, 1.0]])
    count, least = bp.subnormal_pairs(tgt, src)
    assert count == 1 and least == pytest.approx(1e-39, rel=1e-3)


# --- reading SASS (ops/sass.py), on cuobjdump's text format ---

SASS_TEXT = """
\tcode for sm_90a
\t\tFunction : _ZN47_GLOBAL__N__dce42868_14_ring_forces_cu_6b5323d915ring_hop_kernelILb0EEEv
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe20000000800 */
        /*0010*/                   LDS.128 R4, [R2] ;              /* 0x0000000002047984 */
        /*0020*/                   LDS.128 R8, [R2+0x10] ;         /* 0x0000100002087984 */
        /*0030*/                   FADD R0, R4, R8 ;               /* 0x0000000804007221 */
        /*0040*/              @!P0 BRA 0x10 ;                      /* 0xfffffffc00f08947 */
        /*0050*/                   BRA.U !UP0, 0x10 ;              /* 0xfffffffc00f08947 */
        /*0060*/                   EXIT ;                          /* 0x000000000000794d */
        /*0070*/                   BRA 0x70;                       /* 0xfffffffc00fc7947 */
"""


def test_sass_loops_and_pair_loop():
    from nbody_tpu_torch.ops import sass

    (name, code), = sass.parse(SASS_TEXT).items()
    assert name.endswith("ring_hop_kernelILb0EEEv") and len(code) == 8
    assert sass.loops(code) == [(0x10, 0x40, 4), (0x10, 0x50, 5), (0x70, 0x70, 1)]
    assert sass.innermost(sass.loops(code)) == [(0x10, 0x40, 4), (0x70, 0x70, 1)]
    assert sass.pair_loop(code) == (4, 2)


def test_k5i_pair_loops_read_each_variants_kernel(monkeypatch):
    """``tune_r4d_bcast_probe.pair_loops`` takes each variant's kernel by
    its template argument and divides its pair loop by the MUFU count."""
    from nbody_tpu_torch.ops import sass

    body = """
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   MUFU.RSQ R5, R4 ;
        /*0020*/                   MUFU.RSQ R6, R4 ;
        /*0030*/                   FADD R0, R4, R8 ;
        /*0040*/              @!P0 BRA 0x0 ;
"""
    text = "".join(f"\t\tFunction : _ZN12_GLOBAL__N_112bcast_kernelILi{v}EEEvPKf\n"
                   + body.replace("FADD", "FADD" if v else "FMUL") for v in range(4))
    monkeypatch.setattr(sass, "functions", lambda lib: sass.parse(text))
    assert tune_r4d_bcast_probe.pair_loops("lib", log=lambda *a: None) == {
        v: 2.5 for v in bp.VARIANTS}


def test_sass_diff_ignores_the_anonymous_namespace_tag(monkeypatch):
    from nbody_tpu_torch.ops import sass

    other = SASS_TEXT.replace("dce42868_14_ring_forces_cu_6b5323d9",
                              "0badf00d_14_ring_forces_cu_12345678")
    changed = other.replace("FADD R0, R4, R8", "FADD R0, R8, R4")
    texts = {"a": SASS_TEXT, "b": other, "c": changed}
    monkeypatch.setattr(sass, "functions", lambda lib: sass.parse(texts[lib]))
    assert list(sass.diff("a", "b").values()) == [True]
    assert list(sass.diff("a", "c").values()) == [False]
