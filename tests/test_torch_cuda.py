"""The CUDA kernels against their plain versions on a card.  Marked
``cuda``; each test skips where no CUDA card is visible.  On the card
(where jax, which tests/conftest.py imports, may be missing):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.  Exact comparisons: the
values are integers."""

import numpy as np
import pytest
import torch

from vgen_tpu_torch.crypto import secp256k1 as ec
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.ops import fused, pipeline, u256
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import tables

pytestmark = pytest.mark.cuda

K, B = 2, 4096


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)


def _points(bases):
    pts = [ec.scalar_mult_base_fast(s) for s in bases]
    return (u256.as_i32(u256.from_ints([p[0] for p in pts]).T),
            u256.as_i32(u256.from_ints([p[1] for p in pts]).T))


def test_batch_inverse_dx_kernel_equals_plain(dev):
    rng = np.random.default_rng(505)
    bx_i = [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(K)]
    tx_i = [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(B)]
    tx_i[17] = bx_i[0]  # a zero-dx lane
    bx = u256.as_i32(u256.from_ints(bx_i).T)
    tx = u256.as_i32(u256.from_ints(tx_i))
    before = fused.batch_inverse_dx.launches
    got = fused.batch_inverse_dx(bx.to(dev), tx.to(dev))
    torch.cuda.synchronize()
    assert fused.batch_inverse_dx.launches == before + 1
    assert torch.equal(got.cpu(), fused.batch_inverse_dx_plain(bx, tx))


def test_range_glv_step_kernel_equals_plain(dev):
    fmt = AddressFormat.P2PKH
    ivs = Pattern("^1C").match_intervals(fmt)
    lo, hi = (u256.as_i32(a) for a in pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs))))
    tx, ty = tables.ig_table(B, "cpu")
    bx, by = _points([0xABCDEF0123456789, 5])  # window 1 has a zero-dx lane
    rem = torch.tensor([B, B - 9], dtype=torch.int32)
    args = (bx, by, tx, ty, lo, hi, rem)
    got = fused.fused_range_scan_step(fmt, *(a.to(dev) for a in args))
    want = fused.fused_range_scan_step(fmt, *args)
    assert torch.equal(got.cpu(), want)
    assert int(want[:, 0].sum()) > 0


def _step_inputs():
    """The real table, one window based above B and one based at 5 (it
    holds the doubling lane), and a partial second window."""
    tx, ty = tables.ig_table(B, "cpu")
    bx, by = _points([0xABCDEF0123456789, 5])
    rem = torch.tensor([B, B - 9], dtype=torch.int32)
    return bx, by, tx, ty, rem


@pytest.mark.parametrize("fmt", [AddressFormat.P2PKH, AddressFormat.P2WPKH],
                         ids=lambda f: f.value)
def test_range_step_kernel_c_equals_plain(dev, fmt):
    src = {AddressFormat.P2PKH: "^1C", AddressFormat.P2WPKH: "^bc1qq"}[fmt]
    ivs = Pattern(src).match_intervals(fmt)
    lo, hi = (u256.as_i32(a) for a in pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs))))
    bx, by, tx, ty, rem = _step_inputs()
    args = (bx, by, tx, ty, lo, hi, rem)
    before = fused.range_match.launches
    got = fused.fused_range_mask_step(fmt, *(a.to(dev) for a in args),
                                      glv=False)
    torch.cuda.synchronize()
    assert fused.range_match.launches == before + 1
    want = fused.fused_range_mask_step(fmt, *args, glv=False)
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) > 0


@pytest.mark.parametrize("src", ["c[a4]t", "a.{8}$"])
@pytest.mark.parametrize("glv", [False, True], ids=["D", "E"])
@pytest.mark.parametrize("fmt", [AddressFormat.P2PKH, AddressFormat.P2WPKH],
                         ids=lambda f: f.value)
def test_dfa_step_kernels_d_e_equal_plain(dev, fmt, glv, src):
    """Masks and packed rows bit-equal; a.{8}$ has more than 256 states."""
    dfa = Pattern(src).device_dfa(fmt)
    table = torch.from_numpy(dfa.table.astype(np.int32))
    accept = torch.from_numpy(dfa.accept.astype(np.int32))
    bx, by, tx, ty, rem = _step_inputs()
    cpu = (bx, by, tx, ty, table, accept)
    gpu = tuple(a.to(dev) for a in cpu)
    kernel = fused.glv_dfa_match if glv else fused.dfa_match
    before = kernel.launches
    got = fused.fused_scan_mask_step(fmt, *gpu, dfa.start, rem.to(dev), glv)
    rows = fused.fused_scan_step(fmt, *gpu, dfa.start, rem.to(dev), glv)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got.cpu(),
                       fused.fused_scan_mask_step(fmt, *cpu, dfa.start, rem,
                                                  glv))
    assert torch.equal(rows.cpu(),
                       fused.fused_scan_step(fmt, *cpu, dfa.start, rem, glv))


def test_wrapper_rejects_bad_input(dev):
    bx = torch.zeros((K, 8), dtype=torch.int64, device=dev)
    tx = torch.zeros((8, B), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fused.batch_inverse_dx(bx, tx)
    with pytest.raises(ValueError):
        fused.batch_inverse_dx(bx.to(torch.int32), tx[:, ::2])


# -- P2TR: kernels F to I ----------------------------------------------------


@pytest.fixture(scope="module")
def wt():
    return tables.window_table("cpu")


def test_p2tr_ladder_kernels_f_equal_plain(dev, wt):
    """Kernel F, finish=True on both windows (the doubling lane included)
    and finish=False on 256 oracle points."""
    bx, by, tx, ty, _ = _step_inputs()
    inv = fused.batch_inverse_dx(bx, tx)
    cpu = (bx, by, tx, ty, inv, wt)
    before = fused.p2tr_ladder.launches
    got = fused.p2tr_ladder(*(a.to(dev) for a in cpu))
    torch.cuda.synchronize()
    assert fused.p2tr_ladder.launches == before + 1
    for g, w in zip(got, fused.p2tr_ladder_plain(*cpu)):
        assert torch.equal(g.cpu(), w)
    x, y = (t[:, :256].contiguous() for t in (tx, ty))
    got = fused.p2tr_ladder_affine(x.to(dev), y.to(dev), wt.to(dev))
    assert fused.p2tr_ladder.launches == before + 2  # one kernel, two flags
    for g, w in zip(got, fused.p2tr_ladder_affine_plain(x, y, wt)):
        assert torch.equal(g.cpu(), w)


def test_batch_inverse_chain_kernel_g_equals_plain(dev):
    rng = np.random.default_rng(506)
    vals = [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(K * B)]
    for dead in (0, 17, 95):
        vals[dead] = 0
    v = u256.as_i32(u256.from_ints(vals))
    before = fused.batch_inverse_chain.launches
    got = fused.batch_inverse_chain(v.to(dev))
    torch.cuda.synchronize()
    assert fused.batch_inverse_chain.launches == before + 1
    assert torch.equal(got.cpu(), fused.batch_inverse_chain_plain(v))


@pytest.mark.parametrize("kind", ["range", "dfa"], ids=["H", "I"])
def test_p2tr_step_kernels_h_i_equal_plain(dev, wt, kind):
    """Masks and packed rows of whole P2TR steps bit-equal, matches > 0."""
    bx, by, tx, ty, rem = _step_inputs()
    fmt = AddressFormat.P2TR
    if kind == "range":
        ivs = Pattern("^bc1pq").match_intervals(fmt)
        lo, hi = (u256.as_i32(a) for a in pipeline.intervals_to_words(
            ivs, n_words=8, n_slots=pipeline.interval_slot_count(len(ivs))))
        margs, kernel = (lo, hi), fused.p2tr_finish_range
        mask_step = fused.fused_p2tr_range_mask_step
        step = fused.fused_p2tr_range_scan_step
    else:
        dfa = Pattern("q$").device_dfa(fmt)
        margs = (torch.from_numpy(dfa.table.astype(np.int32)),
                 torch.from_numpy(dfa.accept.astype(np.int32)), dfa.start)
        kernel = fused.p2tr_finish_match
        mask_step, step = fused.fused_p2tr_scan_mask_step, fused.fused_p2tr_scan_step

    def on(d):
        return tuple(a.to(d) if torch.is_tensor(a) else a for a in margs)

    cpu = (bx, by, tx, ty)
    gpu = tuple(a.to(dev) for a in cpu)
    before = kernel.launches
    got = mask_step(*gpu, *on(dev), rem.to(dev), wt.to(dev))
    rows = step(*gpu, *on(dev), rem.to(dev), wt.to(dev))
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    want = mask_step(*cpu, *margs, rem, wt)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(rows.cpu(), step(*cpu, *margs, rem, wt))
    assert int(want.sum()) > 0


# -- P2SH-P2WPKH, uncompressed P2PKH, Ethereum: kernels B to E ---------------

NEW_FORMATS = {
    # format: (interval pattern, DFA patterns; a.{8}$ has more than 256 states)
    AddressFormat.P2SH_P2WPKH: ("^3A", ("c[a4]", "a.{8}$")),
    AddressFormat.P2PKH_UNCOMPRESSED: ("^1A", ("c[a4]", "a.{8}$")),
    AddressFormat.ETHEREUM: ("^0xab", ("Ab", "a.{8}$")),
}


@pytest.mark.parametrize("glv", [False, True], ids=["C", "B"])
@pytest.mark.parametrize("fmt", list(NEW_FORMATS), ids=lambda f: f.value)
def test_interval_kernels_b_c_new_formats_equal_plain(dev, fmt, glv):
    ivs = Pattern(NEW_FORMATS[fmt][0]).match_intervals(fmt)
    lo, hi = (u256.as_i32(a) for a in pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs))))
    bx, by, tx, ty, rem = _step_inputs()
    args = (bx, by, tx, ty, lo, hi, rem)
    kernel = fused.range_glv_match if glv else fused.range_match
    before = kernel.launches
    got = fused.fused_range_mask_step(fmt, *(a.to(dev) for a in args),
                                      glv=glv)
    rows = fused.fused_range_scan_step(fmt, *(a.to(dev) for a in args),
                                       glv=glv)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    want = fused.fused_range_mask_step(fmt, *args, glv=glv)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(rows.cpu(), fused.fused_range_scan_step(fmt, *args,
                                                               glv=glv))
    assert int((want > 0).sum()) > 0


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("glv", [False, True], ids=["D", "E"])
@pytest.mark.parametrize("fmt", list(NEW_FORMATS), ids=lambda f: f.value)
def test_dfa_kernels_d_e_new_formats_equal_plain(dev, fmt, glv, case):
    dfa = Pattern(NEW_FORMATS[fmt][1][case]).device_dfa(fmt)
    table = torch.from_numpy(dfa.table.astype(np.int32))
    accept = torch.from_numpy(dfa.accept.astype(np.int32))
    bx, by, tx, ty, rem = _step_inputs()
    cpu = (bx, by, tx, ty, table, accept)
    kernel = fused.glv_dfa_match if glv else fused.dfa_match
    before = kernel.launches
    got = fused.fused_scan_mask_step(fmt, *(a.to(dev) for a in cpu),
                                     dfa.start, rem.to(dev), glv)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = fused.fused_scan_mask_step(fmt, *cpu, dfa.start, rem, glv)
    assert torch.equal(got.cpu(), want)
    assert int((want > 0).sum()) > 0


# The probe kernels of vgen_tpu_torch/probes (the measurement tools), every
# instance at N = 4096 against its plain version on the CPU.
PROBE_N = 4096


def _probe_cases():
    from vgen_tpu_torch.probes import microbench_fieldmul as fm
    from vgen_tpu_torch.probes import microbench_vpu as vpu
    from vgen_tpu_torch.probes import roofline

    def prim(name):
        return lambda a, b, r: roofline.probe_primitive(
            name, a, b, roofline.dfa_table().to(a.device), r)

    cases = [(f"probe_primitive[{n}]", roofline.probe_primitive, prim(n), 2)
             for n in roofline.PRIMITIVES]
    cases += [(f"probe_issue[{vpu.instance_name(op, c)}]", vpu.probe_issue,
               lambda a, b, r, op=op, c=c: vpu.probe_issue(op, c, a, b, r), 16)
              for op, c in vpu.instances()]
    cases += [(f"probe_fieldmul[{m}]", fm.probe_fieldmul,
               lambda a, b, r, m=m: fm.probe_fieldmul(m, a, b, r), 2)
              for m in fm.MODES]
    return cases


PROBE_CASES = _probe_cases()


@pytest.mark.parametrize("case", PROBE_CASES, ids=[c[0] for c in PROBE_CASES])
def test_probe_kernels_equal_plain(dev, case):
    from vgen_tpu_torch.probes import common

    _, wrapper, run, reps = case
    a, b = common.inputs(PROBE_N, seed=4096)
    before = wrapper.launches
    got = run(a.to(dev), b.to(dev), reps)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = run(a, b, reps)
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, a)


# The stage and geometry probes (vgen_tpu_torch/probes: profile_glv,
# proto_vtile, microbench_rows, microbench_layout), every instance at N =
# 4096 against its plain version on the CPU; the tile instances and full
# also against kernel B on the card.
GEOMETRY_N = 4096


def _geometry_cases():
    from vgen_tpu_torch.probes import microbench_layout as ml
    from vgen_tpu_torch.probes import microbench_rows as mr
    from vgen_tpu_torch.probes import profile_glv as pg
    from vgen_tpu_torch.probes import proto_vtile as pv

    cases = [(f"probe_glv_stage[{m}]", pg.probe_glv_stage, "stage",
              lambda args, m=m: pg.probe_glv_stage(m, *args),
              m in ("full", "fullr")) for m in pg.MODES]
    cases += [(f"probe_vtile[{pv.instance_name(v, t)}]", pv.probe_vtile,
               "vtile", lambda args, v=v, t=t: pv.probe_vtile(v, t, *args),
               True) for v, t in pv.instances()]
    cases += [(f"probe_rows[{mr.instance_name(s, m)}]", mr.probe_rows, "rows",
               lambda args, s=s, m=m: mr.probe_rows(s, m, args[0], 256), False)
              for s, m in mr.instances()]
    cases += [(f"probe_layout[{lay}]", ml.probe_layout, "layout",
               lambda args, lay=lay: ml.probe_layout(
                   lay, ml.to_layout(args[0], lay),
                   ml.to_layout(args[1], lay), 8), False)
              for lay in ml.LAYOUTS]
    return cases


GEOMETRY_CASES = _geometry_cases()


@pytest.fixture(scope="module")
def geometry_inputs():
    from vgen_tpu_torch.probes import microbench_layout as ml
    from vgen_tpu_torch.probes import microbench_rows as mr
    from vgen_tpu_torch.probes import profile_glv as pg
    from vgen_tpu_torch.probes import proto_vtile as pv

    return {"stage": pg.stage_inputs(GEOMETRY_N, "cpu", force=True),
            "vtile": pv.vtile_inputs(GEOMETRY_N),
            "rows": (mr.rows_inputs(GEOMETRY_N),),
            "layout": ml.layout_inputs(GEOMETRY_N)}


@pytest.mark.parametrize("case", GEOMETRY_CASES,
                         ids=[c[0] for c in GEOMETRY_CASES])
def test_geometry_probe_kernels_equal_plain(dev, geometry_inputs, case):
    _, wrapper, kind, run, is_b = case
    args = geometry_inputs[kind]
    dargs = tuple(t.to(dev) for t in args)
    before = wrapper.launches
    got = run(dargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = run(args)
    assert torch.equal(got.cpu(), want)
    assert int((want != 0).sum()) > 0
    if is_b:
        assert torch.equal(got, fused.range_glv_match(AddressFormat.P2PKH,
                                                      *dargs))


@pytest.mark.parametrize("chain", [16, 32, 64, 128, 256])
def test_kernel_a_chain_changes_no_value(dev, chain):
    """Kernel A's chain length (the sweep of probes.sweep_inv_chain) leaves
    its canonical output as it is."""
    from vgen_tpu_torch.probes import common

    tx = common.inputs(B, seed=73)[0]
    bx = common.inputs(K, seed=74)[0].T.contiguous()
    want = fused.batch_inverse_dx(bx, tx)
    got = fused.batch_inverse_dx(bx.to(dev), tx.to(dev), chain=chain)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# -- the window schedules of kernel F and the geometries of kernels A, G ----


@pytest.mark.parametrize("schedule", fused.LADDER_WINDOWS,
                         ids=lambda s: f"{s[0]}{'s' if s[1] else 'u'}")
def test_p2tr_ladder_schedule_equals_plain(dev, schedule):
    """Kernel F at every instanced window schedule, both flags, bit-equal
    to its plain version with that schedule's table (the doubling lane
    included)."""
    wt = torch.from_numpy(tables.ladder_table_limbs(*schedule)
                          .view(np.int32))
    bx, by, tx, ty, _ = _step_inputs()
    cpu = (bx, by, tx, ty, fused.batch_inverse_dx(bx, tx), wt)
    got = fused.p2tr_ladder(*(a.to(dev) for a in cpu))
    torch.cuda.synchronize()
    for g, w in zip(got, fused.p2tr_ladder_plain(*cpu)):
        assert torch.equal(g.cpu(), w)
    x, y = (t[:, :256].contiguous() for t in (tx, ty))
    got = fused.p2tr_ladder_affine(x.to(dev), y.to(dev), wt.to(dev))
    for g, w in zip(got, fused.p2tr_ladder_affine_plain(x, y, wt)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("geometry", [(64, 1), (16, 32), (16, 256), (32, 256),
                                      (8, 512), (64, 256), (1, 512)],
                         ids=lambda g: f"m{g[0]}g{g[1]}")
def test_inversion_geometry_equals_plain(dev, geometry):
    """Kernels A and G at (M, G): bit-equal to their plain versions, zero
    lanes guarded to 1 (at K = 2, B = 4096 a group of 512 threads of chains
    of 64 is partly past the last thread)."""
    m, g = geometry
    rng = np.random.default_rng(507)
    bx_i = [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(K)]
    tx_i = [int.from_bytes(rng.bytes(32), "big") % ec.P for _ in range(B)]
    tx_i[17] = bx_i[1]
    bx = u256.as_i32(u256.from_ints(bx_i).T)
    tx = u256.as_i32(u256.from_ints(tx_i))
    got = fused.batch_inverse_dx(bx.to(dev), tx.to(dev), chain=m, group=g)
    want = fused.batch_inverse_dx_plain(bx, tx)
    v = want.clone()
    v[:, [0, 95, K * B - 1]] = 0
    got_g = fused.batch_inverse_chain(v.to(dev), chain=m, group=g)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_g.cpu(), fused.batch_inverse_chain_plain(v))


# Kernels C and D over the persistent tile loop: D in both table forms for
# every hash format, a table over the shared budget, C on windows that are
# empty, partial and full, and the single-key probe's modes.
SINGLE_KEY_DFA = {AddressFormat.P2PKH: "[a-k]$", AddressFormat.P2WPKH: "q$",
                  AddressFormat.P2SH_P2WPKH: "c|[a-k]$",
                  AddressFormat.P2PKH_UNCOMPRESSED: "(?i)^1[a-c]",
                  AddressFormat.ETHEREUM: "[A-F]$"}


def _single_key_inputs(dev, rem=(B, B - 9)):
    """(cpu, gpu) lane inputs (bx, by, tx, ty, inv, remaining), inv from
    kernel A on the card."""
    bx, by, tx, ty, _ = _step_inputs()
    bx, by = (torch.cat([t] * (len(rem) // 2 + 1))[:len(rem)] for t in (bx, by))
    remaining = torch.tensor(rem, dtype=torch.int32)
    inv = fused.batch_inverse_dx(bx.to(dev), tx.to(dev)).cpu()
    cpu = (bx, by, tx, ty, inv, remaining)
    return cpu, tuple(t.to(dev) for t in cpu)


@pytest.mark.parametrize("form", fused.DFA_FORMS)
@pytest.mark.parametrize("fmt", list(fused.FMT_CODE), ids=lambda f: f.value)
def test_dfa_kernel_d_both_forms_equal_plain(dev, fmt, form):
    dfa = Pattern(SINGLE_KEY_DFA[fmt]).device_dfa(fmt)
    table = torch.from_numpy(dfa.table.astype(np.int32))
    accept = torch.from_numpy(dfa.accept.astype(np.int32))
    cpu, gpu = _single_key_inputs(dev)
    before = dict(fused.dfa_match.forms)
    got = fused.dfa_match(fmt, *gpu[:5], table.to(dev), accept.to(dev),
                          dfa.start, gpu[5], form=form)
    torch.cuda.synchronize()
    assert fused.dfa_match.forms[form] == before[form] + 1
    want = fused.dfa_match_plain(fmt, *cpu[:5], table, accept, dfa.start,
                                 cpu[5])
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) > 0


def test_dfa_kernel_d_over_the_budget_takes_the_global_form(dev):
    fmt = AddressFormat.P2PKH
    dfa = Pattern("a.{8}$").device_dfa(fmt)
    table = torch.from_numpy(dfa.table.astype(np.int32))
    accept = torch.from_numpy(dfa.accept.astype(np.int32))
    assert fused.dfa_form(*table.shape) == "global"
    cpu, gpu = _single_key_inputs(dev)
    before = fused.dfa_match.forms["global"]
    got = fused.dfa_match(fmt, *gpu[:5], table.to(dev), accept.to(dev),
                          dfa.start, gpu[5])
    torch.cuda.synchronize()
    assert fused.dfa_match.forms["global"] == before + 1
    assert torch.equal(got.cpu(), fused.dfa_match_plain(
        fmt, *cpu[:5], table, accept, dfa.start, cpu[5]))
    with pytest.raises(ValueError, match="over the shared form"):
        fused.dfa_match(fmt, *gpu[:5], table.to(dev), accept.to(dev),
                        dfa.start, gpu[5], form="shared")


@pytest.mark.parametrize("fmt", list(fused.FMT_CODE), ids=lambda f: f.value)
def test_range_kernel_c_on_empty_partial_and_full_windows(dev, fmt):
    src = {AddressFormat.P2PKH: "^1[A-H]", AddressFormat.P2WPKH: "^bc1q[q-z]",
           AddressFormat.P2SH_P2WPKH: "^3[A-H]",
           AddressFormat.P2PKH_UNCOMPRESSED: "^1[A-H]",
           AddressFormat.ETHEREUM: "^0x[0-3]"}[fmt]
    ivs = Pattern(src).prefilter_intervals(fmt)[0]
    lo, hi = (u256.as_i32(a) for a in pipeline.intervals_to_words(
        ivs, n_slots=pipeline.interval_slot_count(len(ivs))))
    cpu, gpu = _single_key_inputs(dev, rem=(0, 300, B, 1000))
    got = fused.range_match(fmt, *gpu[:5], lo.to(dev), hi.to(dev), gpu[5])
    want = fused.range_match_plain(fmt, *cpu[:5], lo, hi, cpu[5])
    assert torch.equal(got.cpu(), want)
    assert int(want[0].sum()) == 0 and int(want.sum()) > 0


def test_single_key_probe_modes_equal_plain(dev):
    from vgen_tpu_torch.probes import profile_dfa as pd

    cpu, gpu = _single_key_inputs(dev)
    lo, hi = pd.intervals("cpu")
    dfa = pd.pattern_dfa(pd.DFA_PATTERN)
    margs = (lo, hi) + dfa
    for mode in pd.MODES:
        before = pd.probe_single_key.launches
        got = pd.probe_single_key(mode, *gpu[:5], *(
            a.to(dev) if torch.is_tensor(a) else a for a in margs), gpu[5])
        torch.cuda.synchronize()
        assert pd.probe_single_key.launches == before + 1
        want = pd.single_key_plain(mode, *cpu[:5], *margs, cpu[5])
        assert torch.equal(got.cpu(), want), mode
    # the modes that take any hash format, for every one
    for fmt, (iv_src, dfa_src) in pd.TURN_PATTERNS.items():
        m_f = pd.intervals("cpu", fmt, iv_src) + pd.pattern_dfa(dfa_src, fmt)
        for mode in pd.ANY_FORMAT:
            got = pd.probe_single_key(mode, *gpu[:5], *(
                a.to(dev) if torch.is_tensor(a) else a for a in m_f), gpu[5],
                fmt=fmt)
            want = pd.single_key_plain(mode, *cpu[:5], *m_f, cpu[5], fmt=fmt)
            assert torch.equal(got.cpu(), want), (mode, fmt)


# Kernel I's table forms (one tile of one window per block, the bech32m
# walk in registers) and the P2TR probe's modes.
def _p2tr_finish_inputs(dev, rem=(B, B - 9, 0, 1000)):
    """(cpu, gpu) kernel I inputs (X, Z, zi, ok, remaining): random X, Z,
    zi = 1 / Z, a lane with ok 0 and one with Z 0."""
    from vgen_tpu_torch.probes import profile_p2tr_match as ppm

    X, Z, zi, ok, remaining = ppm.inputs("cpu", len(rem), B, remaining=rem)
    Z = Z.clone()
    Z[:, 33] = 0
    cpu = (X, Z, zi, ok, remaining)
    return cpu, tuple(t.to(dev) for t in cpu)


def _p2tr_dfa(src):
    dfa = Pattern(src).device_dfa(AddressFormat.P2TR)
    return (torch.from_numpy(dfa.table.astype(np.int32)),
            torch.from_numpy(dfa.accept.astype(np.int32)), dfa.start)


@pytest.mark.parametrize("form", fused.DFA_FORMS)
@pytest.mark.parametrize("src", ["q$", "[ac-h]d", "a.{7}$"])
def test_p2tr_finish_match_both_forms_equal_plain(dev, src, form):
    table, accept, start = _p2tr_dfa(src)
    cpu, gpu = _p2tr_finish_inputs(dev)
    before = dict(fused.p2tr_finish_match.forms)
    got = fused.p2tr_finish_match(*gpu[:4], table.to(dev), accept.to(dev),
                                  start, gpu[4], form=form)
    torch.cuda.synchronize()
    assert fused.p2tr_finish_match.forms[form] == before[form] + 1
    want = fused.p2tr_finish_match_plain(*cpu[:4], table, accept, start,
                                         cpu[4])
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) > 0 and int(want[2].sum()) == 0


def test_p2tr_finish_match_over_the_budget_takes_the_global_form(dev):
    table, accept, start = _p2tr_dfa("a.{8}$")  # 514 states
    assert table.shape[0] > 237
    assert fused.dfa_form(*table.shape) == "global"
    cpu, gpu = _p2tr_finish_inputs(dev)
    before = fused.p2tr_finish_match.forms["global"]
    got = fused.p2tr_finish_match(*gpu[:4], table.to(dev), accept.to(dev),
                                  start, gpu[4])
    torch.cuda.synchronize()
    assert fused.p2tr_finish_match.forms["global"] == before + 1
    assert torch.equal(got.cpu(), fused.p2tr_finish_match_plain(
        *cpu[:4], table, accept, start, cpu[4]))
    with pytest.raises(ValueError, match="over the shared form"):
        fused.p2tr_finish_match(*gpu[:4], table.to(dev), accept.to(dev),
                                start, gpu[4], form="shared")


def test_p2tr_match_probe_modes_equal_plain(dev):
    from vgen_tpu_torch.probes import profile_p2tr_match as ppm

    cpu, gpu = _p2tr_finish_inputs(dev)
    dfa = _p2tr_dfa("q$")
    for mode in ppm.MODES:
        for form in (fused.DFA_FORMS if mode in ppm.FORM_WALKS else (None,)):
            before = ppm.probe_p2tr_match.launches
            got = ppm.probe_p2tr_match(mode, *gpu[:4], dfa[0].to(dev),
                                       dfa[1].to(dev), dfa[2], gpu[4],
                                       form=form)
            torch.cuda.synchronize()
            assert ppm.probe_p2tr_match.launches == before + 1
            want = ppm.match_plain(mode, *cpu[:4], *dfa, cpu[4])
            assert torch.equal(got.cpu(), want), (mode, form)


# -- the table kernels T1 and T2 ---------------------------------------------


def _table_bases(count, points):
    return u256.as_i32(tables._point_limbs(
        [tables._doubling_chain(p, fused.table_steps(count)) for p in points]))


@pytest.mark.parametrize("count", [1, 100, 300, 4096])
def test_table_kernels_t1_t2_equal_plain(dev, count):
    """T1 (its one-block steps, and single steps past 256 columns) on two
    rows and T2 in both layouts, against their plain versions."""
    b = _table_bases(count, (ec.G, ec.scalar_mult(7)))
    before = fused.table_grow.launches
    got = fused.table_grow(b.to(dev), count)
    torch.cuda.synchronize()
    assert (fused.table_grow.launches - before
            == len(fused.table_launches(count)))
    want = fused.table_grow_plain(b, count)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    zi = fused.batch_inverse_chain_plain(want[2])
    before = fused.table_affine.launches
    tbl = fused.table_affine(got[0], got[1], zi.to(dev), 2, True)
    one = [t[:, :count].contiguous() for t in (want[0], want[1], zi)]
    txy = fused.table_affine(*(t.to(dev) for t in one), 1, False)
    torch.cuda.synchronize()
    assert fused.table_affine.launches == before + 2
    assert torch.equal(tbl.cpu(), fused.table_affine_plain(*want[:2], zi, 2,
                                                           True))
    for g, w in zip(txy, fused.table_affine_plain(*one, 1, False)):
        assert torch.equal(g.cpu(), w)


def test_table_grow_kernel_raises_on_infinity(dev):
    """A base that is not 2^s G: G + (-G) at step 1 is counted on the card
    and refused."""
    b = _table_bases(4, (ec.G,))
    b[0, 1] = u256.as_i32(tables._point_limbs([[(ec.G[0], ec.P - ec.G[1])]]))[
        0, 0]
    with pytest.raises(ValueError, match="1 lanes met the point at infinity"):
        fused.table_grow(b.to(dev), 4)


@pytest.mark.parametrize("count", [4096, 5000])
def test_ig_table_built_on_the_card_equals_host_build(dev, count):
    tx, ty = tables.ig_table(count, dev)
    want = tables.upload_ig_table(*tables.build_ig_table_limbs(count), "cpu")
    assert torch.equal(tx.cpu(), want[0]) and torch.equal(ty.cpu(), want[1])


def test_ladder_table_built_on_the_card_equals_host_build(dev):
    for schedule in ((8, False), (13, True)):
        got = tables.ladder_table(dev, *schedule)
        want = tables.ladder_table_limbs(*schedule)
        assert torch.equal(got.cpu(), u256.as_i32(want)), schedule
