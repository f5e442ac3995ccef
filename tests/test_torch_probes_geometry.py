"""The stage and geometry probes' plain versions (``vgen_tpu_torch/probes``
``profile_glv``, ``proto_vtile``, ``microbench_rows``,
``microbench_layout``) against the JAX bodies of the TPU probes they port,
on the same numpy-seeded inputs: the bodies of ``scripts/profile_glv.py``
:90-159 and ``scripts/microbench_layout.py`` :64-71 rebuilt here from the
JAX package's functions (both scripts build their inputs at import),
``scripts/proto_vtile.py``'s kernel body (``_ec_finish_x`` and
``glv_interval_mask``) on its own input generator, and
``scripts/microbench_rows.py``'s ``_chain_body``, imported, at 256 steps.
Also: each tool exits non-zero without a card, a wrapper raises for
tensors that are neither on the CPU nor on CUDA, and every CUDA source
the build compiles ships as package data.  Exact: every value is an
integer."""

import fnmatch
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu.crypto import secp256k1 as jec
from vgen_tpu.crypto.address import AddressFormat as JAddressFormat
from vgen_tpu.ops import encode as jencode
from vgen_tpu.ops import field as jfield
from vgen_tpu.ops import pallas_fused
from vgen_tpu.ops import pipeline as jpipeline
from vgen_tpu.ops import u256 as ju256
from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.csrc import build
from vgen_tpu_torch.ops import fused, u256
from vgen_tpu_torch.probes import microbench_layout as ml
from vgen_tpu_torch.probes import microbench_rows as mr
from vgen_tpu_torch.probes import profile_glv as pg
from vgen_tpu_torch.probes import proto_vtile as pv
from vgen_tpu_torch.probes import sweep_inv_chain

STAGE_B = 256  # lanes of one window
VTILE_B = 512
ROW_LANES, ROW_STEPS = 256, 256
LAYOUT_N, LAYOUT_R = 256, 8


def _np32(t: torch.Tensor) -> np.ndarray:
    return (t.to(torch.int64) & u256.MASK32).numpy().astype(np.uint32)


def _j16(t: torch.Tensor):
    """(8, ...) int32 32-bit limbs -> the JAX package's (16, ...) limbs."""
    return jnp.asarray(u256.limbs32_to_16(_np32(t)))


def _ints16(limbs16):
    """JAX (16, N) 16-bit limbs -> Python ints."""
    return u256.to_ints(u256.limbs16_to_32(np.asarray(limbs16)))


# ---------------------------------------------------------------------------
# probe_glv_stage: scripts/profile_glv.py's reduced kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage():
    """The port's stage inputs (one window, the FORCED lanes' ec hits) and
    the JAX body's shared pieces: x3, valid and xs = (x, beta x, beta^2 x)
    of ``_ec_finish_x``, and a cache of its hash masks."""
    args = pg.stage_inputs(STAGE_B, "cpu", force=True)
    bx, by, tx, ty, inv, lo, hi, remaining = args
    x3, valid = pallas_fused._ec_finish_x(_j16(bx.T), _j16(by.T), _j16(tx),
                                          _j16(ty), _j16(inv))
    beta = ju256.constant(jec.BETA, x3.shape[1:])
    beta2 = ju256.constant(jec.BETA2, x3.shape[1:])
    xs = (x3, jfield.mul(x3, beta), jfield.mul(x3, beta2))
    return {"args": args, "x3": x3, "valid": valid, "xs": xs, "beta": beta,
            "lo": jnp.asarray(_np32(lo)), "hi": jnp.asarray(_np32(hi)),
            "rem": int(remaining[0]), "hash": {}}


def _mulc(av, bv):
    """``profile_glv.py`` :107-119, the column-accumulator multiply."""
    n = ju256.NLIMBS
    zero = jnp.zeros(av.shape[1:], jnp.uint32)
    cols = [zero] * (2 * n)
    for j in range(n):
        q = av * bv[j][None]
        lov = q & ju256.LIMB_MASK
        hiv = q >> ju256.LIMB_BITS
        for ii in range(n):
            cols[ii + j] = cols[ii + j] + lov[ii]
            cols[ii + j + 1] = cols[ii + j + 1] + hiv[ii]
    prod, _ = ju256.carry_propagate(cols, 2 * n)
    return jfield._fold512(prod)


def _jax_xs(stage, mode):
    """The ec modes' values of ``profile_glv.py`` :100-130."""
    xs = stage["xs"]
    for _ in range(pg.extra_muls(mode)):
        mul = _mulc if mode == "ecc" else jfield.mul
        xs = tuple(mul(xv, stage["beta"]) for xv in xs)
    return xs


def _jax_hash_mask(stage, v, pi, resh):
    """Bit 2v + pi of ``profile_glv.py`` :138-154 (cached: the modes share
    their hashes)."""
    key = (v, pi, resh)
    if key not in stage["hash"]:
        xb = ju256.to_bytes_be(stage["xs"][v])
        if resh:
            xb = xb.reshape(32, 8, STAGE_B // 8)
        prefix = jnp.full((1,) + xb.shape[1:], 2 + pi, dtype=jnp.uint32)
        h = jencode.hash160_33(jnp.concatenate([prefix, xb], axis=0),
                               unroll=True)
        m = jpipeline.in_intervals(jpipeline.bytes_be_words(h), stage["lo"],
                                   stage["hi"])
        if resh:
            m = m.reshape(STAGE_B)
        stage["hash"][key] = jnp.where(m, jnp.int32(1 << (2 * v + pi)), 0)
    return stage["hash"][key]


def _jax_stage(stage, mode):
    """The body of ``profile_glv.py`` :90-159 for one window -> (B,)."""
    mask = jnp.zeros((STAGE_B,), dtype=jnp.int32)
    if mode.startswith("ec"):
        for v, xv in enumerate(_jax_xs(stage, mode)):
            mask = mask | jnp.where(xv[0] == jnp.uint32(v), jnp.int32(1), 0)
    else:
        n_var = {"hash2": 1, "hash2r": 1, "full": 3, "fullr": 3}[mode]
        for v in range(n_var):
            for pi in range(2):
                mask = mask | _jax_hash_mask(stage, v, pi, mode.endswith("r"))
    gidx = jnp.arange(STAGE_B, dtype=jnp.int32)
    valid = stage["valid"] & (gidx < stage["rem"])
    return np.asarray(jnp.where(valid, mask, 0))


@pytest.mark.parametrize("mode", list(pg.MODES))
def test_stage_plain_equals_jax_body(stage, mode):
    got = pg.probe_glv_stage(mode, *stage["args"])
    assert got.shape == (1, STAGE_B)
    want = _jax_stage(stage, mode)
    np.testing.assert_array_equal(got[0].numpy(), want)
    if mode.startswith("ec"):
        # the forced lanes of this mode's multiplies hit, and only they
        lanes = [lane for lane, (_, extra) in pg.FORCED.items()
                 if extra == pg.extra_muls(mode)]
        assert np.flatnonzero(want).tolist() == lanes
    else:
        assert np.count_nonzero(want) > 0


@pytest.mark.parametrize("mode", ["ec", "ec2", "ecc"])
def test_stage_values_equal_jax(stage, mode):
    """All three values of every lane, not only their low 16 bits."""
    x3 = u256.to_i64(u256.as_i32(u256.limbs16_to_32(np.asarray(stage["x3"]))))
    got = pg.stage_values(mode, x3)
    for g, w in zip(got, _jax_xs(stage, mode)):
        assert u256.to_ints(g) == _ints16(w)


def test_stage_modes_agree(stage):
    """ecc's mask is ec2's, the two-lane modes' are the one-lane modes',
    and full is kernel B's plain P2PKH mask."""
    args = stage["args"]
    out = {m: pg.probe_glv_stage(m, *args) for m in pg.MODES}
    assert torch.equal(out["ecc"], out["ec2"])
    assert torch.equal(out["hash2r"], out["hash2"])
    assert torch.equal(out["fullr"], out["full"])
    assert torch.equal(out["full"], fused.range_glv_match_plain(
        AddressFormat.P2PKH, *args))
    assert torch.equal(out["hash2"], out["full"] & 3)


# ---------------------------------------------------------------------------
# probe_vtile: scripts/proto_vtile.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vtile():
    """The script's generator (``proto_vtile.py`` :110-123) at B lanes, and
    the port's inputs from its own copy of it."""
    rng = np.random.RandomState(7)
    mk = lambda shape: rng.randint(0, 1 << 16, size=shape).astype(np.uint32)
    tx, ty, inv = mk((16, VTILE_B)), mk((16, VTILE_B)), mk((16, VTILE_B))
    bx, by = mk((16,)), mk((16,))
    lo = np.zeros((8, 5), dtype=np.uint32)
    hi = np.zeros((8, 5), dtype=np.uint32)
    lo[:, 4] = 1
    lo[0] = [0, 0, 0, 0, 0]
    hi[0] = [1 << 24, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF]
    return {"jax": (bx, by, tx, ty, inv, lo, hi),
            "args": pv.vtile_inputs(VTILE_B)}


def test_vtile_inputs_are_the_scripts(vtile):
    bx, by, tx, ty, inv, lo, hi = vtile["jax"]
    got = vtile["args"]
    want = [u256.limbs16_to_32(bx[:, None]).T, u256.limbs16_to_32(by[:, None]).T,
            u256.limbs16_to_32(tx), u256.limbs16_to_32(ty),
            u256.limbs16_to_32(inv)]
    for g, w in zip(got[:5], want):
        np.testing.assert_array_equal(_np32(g), w)
    np.testing.assert_array_equal(_np32(got[5]), lo)
    np.testing.assert_array_equal(_np32(got[6]), hi)
    assert got[7].tolist() == [VTILE_B]


def test_vtile_plain_equals_jax_body(vtile):
    """The body of ``make_vtile_range_glv`` (:44-60) on one (V, T) tile
    covering the window: its output does not depend on (V, T)."""
    bx, by, tx, ty, inv, lo, hi = vtile["jax"]
    j = jnp.asarray
    x3, valid = pallas_fused._ec_finish_x(j(bx)[:, None], j(by)[:, None],
                                          j(tx), j(ty), j(inv))
    mask = jpipeline.glv_interval_mask(JAddressFormat.P2PKH, x3, None, j(lo),
                                       j(hi), unroll=True)
    want = np.asarray(jnp.where(valid, mask, 0))
    got = pv.probe_vtile_plain(*vtile["args"])
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert np.count_nonzero(want) > 0


@pytest.mark.parametrize("v,t", pv.instances(),
                         ids=[pv.instance_name(*i) for i in pv.instances()])
def test_vtile_wrapper_on_cpu_is_kernel_b(vtile, v, t):
    assert torch.equal(pv.probe_vtile(v, t, *vtile["args"]),
                       fused.range_glv_match_plain(AddressFormat.P2PKH,
                                                   *vtile["args"]))


# ---------------------------------------------------------------------------
# probe_rows: scripts/microbench_rows.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rows_script():
    import scripts.microbench_rows as script

    saved = script.CH_LEN
    script.CH_LEN = ROW_STEPS
    yield script
    script.CH_LEN = saved


def _full2d_jnp(x, steps, mul):
    """``make_full2d``'s body (``microbench_rows.py`` :82-90) in jnp."""
    r = x
    for i in range(steps // 16):
        if mul and i % 4 == 0:
            r = r * x + jnp.uint32(1)
        else:
            r = (r + x) ^ ((r << 7) | (r >> 25))
    return r


@pytest.mark.parametrize("shape,mul", mr.instances(),
                         ids=[mr.instance_name(*i) for i in mr.instances()])
def test_rows_plain_equals_jax_chain(rows_script, shape, mul):
    x = mr.rows_inputs(ROW_LANES)
    xj = jnp.asarray(np.arange(16 * ROW_LANES, dtype=np.uint32)
                     .reshape(16, ROW_LANES))
    np.testing.assert_array_equal(_np32(x), np.asarray(xj))
    got = _np32(mr.probe_rows(shape, mul, x, ROW_STEPS))
    if shape == "full2d":
        want = np.asarray(_full2d_jnp(xj, ROW_STEPS, mul))
    else:
        rows = [xj[i] for i in range(16)]
        if shape == "row2d":  # the script's (LANES // 128, 128) rows
            rows = [r.reshape(ROW_LANES // 128, 128) for r in rows]
        want = np.asarray(rows_script._chain_body(rows[0], rows, mul))
        want = want.reshape(1, ROW_LANES)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# probe_layout: scripts/microbench_layout.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layout():
    """The script's chain (``microbench_layout.py`` :67-71) on its inputs
    (:85-87), each step's ``& 0xFFFF`` checked to be the identity."""
    rng = np.random.default_rng(7)
    a = jnp.asarray(rng.integers(0, 1 << 16, size=(16, LAYOUT_N),
                                 dtype=np.uint32))
    b = jnp.asarray(rng.integers(0, 1 << 16, size=(16, LAYOUT_N),
                                 dtype=np.uint32))
    for _ in range(LAYOUT_R):
        weak = jfield.mul_weak(a, b)
        r = weak & jnp.uint32(0xFFFF)
        np.testing.assert_array_equal(np.asarray(r), np.asarray(weak))
        a = r
        b = b ^ a
    return np.asarray(u256.limbs16_to_32(np.asarray(a)))


@pytest.mark.parametrize("lay", list(ml.LAYOUTS))
def test_layout_plain_equals_jax_chain(layout, lay):
    """``mul_weak`` returns a representative below 2^256, the card's
    ``fe_mul`` the canonical one below p: they differ only where the
    product mod p is below 2^256 - p = 2^32 + 977, about 2^-224 per
    multiply for these seeded inputs, so the two chains are equal here.
    Every layout holds the same values, converted back."""
    a, b = ml.layout_inputs(LAYOUT_N)
    la, lb = ml.to_layout(a, lay), ml.to_layout(b, lay)
    assert tuple(la.shape) == ml.layout_shape(lay, LAYOUT_N)
    assert torch.equal(ml.from_layout(la, lay), a)
    got = ml.probe_layout(lay, la, lb, LAYOUT_R)
    assert tuple(got.shape) == ml.layout_shape(lay, LAYOUT_N)
    np.testing.assert_array_equal(_np32(ml.from_layout(got, lay)), layout)


# ---------------------------------------------------------------------------
# Wrappers, tools, packaging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda: pg.probe_glv_stage("full", *(t.to("meta") for t in
                                         pv.vtile_inputs(256))),
    lambda: pv.probe_vtile(1, 256, *(t.to("meta") for t in
                                     pv.vtile_inputs(256))),
    lambda: mr.probe_rows("row1d", False, mr.rows_inputs(128).to("meta"), 64),
    lambda: ml.probe_layout("lane_major", *(ml.to_layout(t, "lane_major")
                                            .to("meta") for t in
                                            ml.layout_inputs(128)), 1),
], ids=["probe_glv_stage", "probe_vtile", "probe_rows", "probe_layout"])
def test_wrapper_raises_for_tensors_off_the_cpu(call):
    """A tensor that is neither on the CPU nor on a card: no plain
    version, no launch, an error."""
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("tool", [pg, pv, mr, ml, sweep_inv_chain],
                         ids=["profile_glv", "proto_vtile", "microbench_rows",
                              "microbench_layout", "sweep_inv_chain"])
def test_tool_exits_without_a_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tool.main([])
    assert exc.value.code not in (0, None)


def test_every_cuda_source_ships_as_package_data():
    """Each .cu/.cuh file a unit of ``csrc/build.py`` compiles matches a
    package-data glob of its package in ``pyproject.toml``, so an
    installed copy can build every unit."""
    with open(build.CSRC.parents[1] / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    seen = 0
    for unit in build.UNITS + build.PROBE_UNITS:
        for d in build._source_dirs(unit):
            globs = data.get(f"vgen_tpu_torch.{d.name}", [])
            for p in d.iterdir():
                if p.suffix in (".cu", ".cuh"):
                    seen += 1
                    assert any(fnmatch.fnmatch(p.name, g) for g in globs), (
                        f"{d.name}/{p.name} is not package data")
    assert seen > 0
