"""The scan steps: nine CUDA kernels and the pack tail.

One super-step covers K windows of B keys.  Window k adds its base point
(bx[k], by[k]) = base_k * G to every table point i*G, i = 1..B:

1. kernel A, ``batch_inverse_dx``: canonical inverses of dx = tx[b] - bx[k]
   for all K*B lanes, one Montgomery batch inversion;
2. one match kernel over all K*B lanes:
   - B, ``range_glv_match``: x-only finish, x * beta^v, six hash160s,
     interval compare -> a 6-bit GLV variant mask (random interval scans);
   - C, ``range_match``: full finish, one hash160 with the prefix of y's
     parity, interval compare -> 0/1 (range interval scans);
   - D, ``dfa_match``: full finish, hash160, address symbols, DFA walk ->
     0/1 (range scans of any other regex);
   - E, ``glv_dfa_match``: x-only finish, the six variants through symbols
     and the DFA -> a 6-bit mask (random scans of any other regex);
3. ``pack_tail`` (PyTorch ops): one (K, 34) int32 row per window,
   [count, ops, 16 highest matching indices, their masks].

P2TR (no GLV: the tweak rebinds the key) runs four more kernels between
kernel A and the pack (``csrc/p2tr.cu``):

- F, ``p2tr_ladder``: full finish, even-Y internal key, TapTweak tagged
  hash t, Q = P + t*G by 32 fixed 8-bit windows of lean Jacobian adds ->
  X, Z (8, K*B) and ok (K*B,);
- G, ``batch_inverse_chain``: canonical inverses of Z, zero guarded to 1;
- H, ``p2tr_finish_range``: qx = X * zi^2, 8-word interval compare -> 0/1;
- I, ``p2tr_finish_match``: qx, bech32m symbols, DFA walk -> 0/1.

Each kernel wrapper runs its plain PyTorch version when every tensor lies on
the CPU; for CUDA tensors it checks them and launches the kernel, or raises.
``<wrapper>.launches`` counts kernel launches (and nothing else).

Counterparts in ``vgen_tpu/ops/pallas_fused.py``: ``batch_inverse_dx_pallas``,
``fused_range_match_fn``, ``fused_match_fn``, ``_pack_tail``,
``fused_range_scan_step``, ``fused_range_mask_step``, ``fused_scan_step``,
``fused_scan_mask_step``, ``p2tr_ladder_finish_fn``, ``p2tr_ladder_fn``,
``batch_inverse_chain_pallas``, ``p2tr_finish_range_fn``,
``p2tr_finish_match_fn`` and the ``fused_p2tr_*`` steps.
"""

from __future__ import annotations

import torch

from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.ops import curve, encode, field, pipeline, sha256, u256

# Formats whose device-checked value is hash160 of the compressed public
# key (P2WPKH hashes exactly what P2PKH hashes): kernels B to E serve these.
HASH160_FORMATS = (AddressFormat.P2PKH, AddressFormat.P2WPKH)
# ... and P2TR, through kernels F to I: the formats the port scans on a device
DEVICE_FORMATS = HASH160_FORMATS + (AddressFormat.P2TR,)

GLV_KEYS = 6  # keys checked per table position: {+-k, +-lk, +-l^2 k}

# the DFA kernels' format argument (csrc/dfa.cuh kFmtP2PKH, kFmtP2WPKH)
_DFA_FMT_CODE = {AddressFormat.P2PKH: 0, AddressFormat.P2WPKH: 1}

# elements per thread chain in kernel A (the largest power of two <= this
# that divides K*B)
INV_CHAIN = 64


def _chain_len(n: int, limit: int = INV_CHAIN) -> int:
    m = limit
    while n % m:
        m //= 2
    return m


def _all_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(name: str, specs) -> torch.device:
    """specs: [(arg name, tensor, expected shape)].  All must be contiguous
    int32 CUDA tensors on one device."""
    dev = specs[0][1].device
    for arg, t, shape in specs:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}"
                             " (all CUDA, or all CPU for the plain version)")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected int32")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(unit: str, entry: str, *args) -> None:
    """Call the C entry point vgen_<entry> of the kernel library ``unit``
    on the current stream (ints and pointers, the stream appended)."""
    from vgen_tpu_torch.csrc import build

    lib = build.load(unit)
    rc = getattr(lib, f"vgen_{entry}")(*args)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed, cudaError {rc}")


# ---------------------------------------------------------------------------
# Kernel A: batch inversion of the window differences
# ---------------------------------------------------------------------------


def batch_inverse_dx_plain(bx: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A: bx (K, 8), tx (8, B) int32 ->
    (8, K*B) int32 canonical inverses of tx[b] - bx[k] at k*B + b, zero
    differences guarded to 1."""
    K, B = bx.shape[0], tx.shape[1]
    bxl = u256.to_i64(bx).T.reshape(8, K, 1)
    dx = field.sub(u256.to_i64(tx).reshape(8, 1, B), bxl).reshape(8, K * B)
    one = u256.constant(1, dx).expand_as(dx)
    dx = u256.select(u256.is_zero(dx), one, dx)
    C = _chain_len(K * B)
    inv = field.batch_inverse_chain(dx.reshape(8, C, K * B // C))
    return u256.to_i32(inv.reshape(8, K * B))


def batch_inverse_dx(bx: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    """Kernel A (``csrc/kernels.cu``): same contract as
    ``batch_inverse_dx_plain``, one launch for all K*B lanes."""
    if _all_cpu(bx, tx):
        return batch_inverse_dx_plain(bx, tx)
    K, B = bx.shape[0], tx.shape[1]
    dev = _check_cuda("batch_inverse_dx", [("bx", bx, (K, 8)),
                                           ("tx", tx, (8, B))])
    out = torch.empty((8, K * B), dtype=torch.int32, device=dev)
    scratch = torch.empty_like(out)
    with torch.cuda.device(dev):
        _launch("kernels", "batch_inverse_dx", bx.data_ptr(), tx.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), K, B, _chain_len(K * B),
                _stream(dev))
    batch_inverse_dx.launches += 1
    return out


batch_inverse_dx.launches = 0


# ---------------------------------------------------------------------------
# Kernel B: x-only finish + six hash160s + interval compare
# ---------------------------------------------------------------------------


def _lanes(bx, by, tx, ty, inv):
    """int64 (8, K, B) views of the window bases, table points and
    inverses for lane (k, b)."""
    K, B = bx.shape[0], tx.shape[1]
    return (u256.to_i64(bx).T.reshape(8, K, 1).expand(8, K, B),
            u256.to_i64(by).T.reshape(8, K, 1).expand(8, K, B),
            u256.to_i64(tx).reshape(8, 1, B).expand(8, K, B),
            u256.to_i64(ty).reshape(8, 1, B).expand(8, K, B),
            u256.to_i64(inv).reshape(8, K, B))


def _in_window(remaining, K: int, B: int) -> torch.Tensor:
    """(K, B) bool: lane b of window k is inside (b < remaining[k])."""
    b_idx = torch.arange(B, device=remaining.device).reshape(1, B)
    return b_idx < remaining.to(torch.int64).reshape(K, 1)


def range_glv_match_plain(bx, by, tx, ty, inv, lo, hi, remaining):
    """Plain version of kernel B.  bx, by (K, 8); tx, ty (8, B);
    inv (8, K*B); lo, hi (n_slots, 5); remaining (K,); all int32 ->
    (K, B) int32 mask, bit 2v+pi set when hash160((2+pi) || beta^v x)
    lies in an interval; 0 where dx == 0 or b >= remaining[k]."""
    K, B = bx.shape[0], tx.shape[1]
    x3, valid = curve.ec_finish_x(*_lanes(bx, by, tx, ty, inv))
    valid = valid & _in_window(remaining, K, B)
    mask = pipeline.glv_interval_mask(x3, u256.to_i64(lo), u256.to_i64(hi))
    return torch.where(valid, mask, 0).to(torch.int32)


def _interval_specs(name, bx, by, tx, ty, inv, lo, hi, remaining):
    K, B, S = bx.shape[0], tx.shape[1], lo.shape[0]
    if not 1 <= S <= pipeline.MAX_INTERVALS:
        raise ValueError(f"{name}: {S} interval slots, expected "
                         f"1..{pipeline.MAX_INTERVALS}")
    return _check_cuda(name, [
        ("bx", bx, (K, 8)), ("by", by, (K, 8)), ("tx", tx, (8, B)),
        ("ty", ty, (8, B)), ("inv", inv, (8, K * B)), ("lo", lo, (S, 5)),
        ("hi", hi, (S, 5)), ("remaining", remaining, (K,)),
    ])


def _launch_interval(entry: str, args):
    """Launch kernel B or C (same C signature) -> (K, B) int32."""
    bx, by, tx, ty, inv, lo, hi, remaining = args
    K, B, S = bx.shape[0], tx.shape[1], lo.shape[0]
    dev = _interval_specs(entry, *args)
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("kernels", entry, bx.data_ptr(), by.data_ptr(), tx.data_ptr(),
                ty.data_ptr(), inv.data_ptr(), lo.data_ptr(), hi.data_ptr(), S,
                remaining.data_ptr(), out.data_ptr(), K, B, _stream(dev))
    return out


def range_glv_match(bx, by, tx, ty, inv, lo, hi, remaining):
    """Kernel B (``csrc/kernels.cu``): same contract as
    ``range_glv_match_plain``, one launch for all K*B lanes."""
    args = (bx, by, tx, ty, inv, lo, hi, remaining)
    if _all_cpu(*args):
        return range_glv_match_plain(*args)
    out = _launch_interval("range_glv_match", args)
    range_glv_match.launches += 1
    return out


range_glv_match.launches = 0


# ---------------------------------------------------------------------------
# Kernel C: full finish + one hash160 + interval compare
# ---------------------------------------------------------------------------


def range_match_plain(bx, by, tx, ty, inv, lo, hi, remaining):
    """Plain version of kernel C.  Same inputs as kernel B -> (K, B) int32,
    1 where hash160((2 + (y & 1)) || x) of B + T lies in an interval, else
    0; 0 where dx == 0 or b >= remaining[k]."""
    K, B = bx.shape[0], tx.shape[1]
    x3, y3, valid = curve.ec_finish(*_lanes(bx, by, tx, ty, inv))
    valid = valid & _in_window(remaining, K, B)
    hit = pipeline.in_intervals(pipeline.hash160_words(x3, y3),
                                u256.to_i64(lo), u256.to_i64(hi))
    return (hit & valid).to(torch.int32)


def range_match(bx, by, tx, ty, inv, lo, hi, remaining):
    """Kernel C (``csrc/kernels.cu``): same contract as
    ``range_match_plain``, one launch for all K*B lanes."""
    args = (bx, by, tx, ty, inv, lo, hi, remaining)
    if _all_cpu(*args):
        return range_match_plain(*args)
    out = _launch_interval("range_match", args)
    range_match.launches += 1
    return out


range_match.launches = 0


# ---------------------------------------------------------------------------
# Kernels D and E: address symbols + DFA walk
# ---------------------------------------------------------------------------


def dfa_match_plain(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept, start,
                    remaining):
    """Plain version of kernel D.  bx, by (K, 8); tx, ty (8, B);
    inv (8, K*B); dfa_table (S, W) and dfa_accept (S,) int32 (the pattern's
    ``DeviceDFA`` for ``fmt``); start int; remaining (K,) -> (K, B) int32,
    1 where the address of B + T is accepted; 0 where dx == 0 or
    b >= remaining[k]."""
    K, B = bx.shape[0], tx.shape[1]
    x3, y3, valid = curve.ec_finish(*_lanes(bx, by, tx, ty, inv))
    valid = valid & _in_window(remaining, K, B)
    hit = pipeline.dfa_matches(fmt, pipeline.hash160_words(x3, y3),
                               dfa_table, dfa_accept, start)
    return (hit & valid).to(torch.int32)


def glv_dfa_match_plain(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept,
                        start, remaining):
    """Plain version of kernel E.  Same inputs as kernel D -> (K, B) int32
    6-bit masks, bit 2v+pi set when the address of
    hash160((2+pi) || beta^v x) is accepted; 0 where dx == 0 or
    b >= remaining[k]."""
    K, B = bx.shape[0], tx.shape[1]
    x3, valid = curve.ec_finish_x(*_lanes(bx, by, tx, ty, inv))
    valid = valid & _in_window(remaining, K, B)
    mask = pipeline.glv_dfa_mask(fmt, x3, dfa_table, dfa_accept, start)
    return torch.where(valid, mask, 0).to(torch.int32)


def _launch_dfa(entry: str, fmt, args):
    """Check the DFA kernels' inputs and launch kernel D or E."""
    bx, by, tx, ty, inv, dfa_table, dfa_accept, start, remaining = args
    if fmt not in _DFA_FMT_CODE:
        check_format(fmt)  # raises for the formats still to port
        raise ValueError(f"{entry}: kernels D and E serve the hash160 "
                         f"formats; {fmt.value} scans through kernels F to I")
    K, B = bx.shape[0], tx.shape[1]
    S, W = dfa_table.shape
    if W != pipeline.FORMAT_DFA_WIDTH[fmt]:
        raise ValueError(f"{entry}: DFA width {W}, expected "
                         f"{pipeline.FORMAT_DFA_WIDTH[fmt]} for {fmt.value}")
    if not 0 <= int(start) < S:
        raise ValueError(f"{entry}: start state {start} outside 0..{S - 1}")
    dev = _check_cuda(entry, [
        ("bx", bx, (K, 8)), ("by", by, (K, 8)), ("tx", tx, (8, B)),
        ("ty", ty, (8, B)), ("inv", inv, (8, K * B)),
        ("dfa_table", dfa_table, (S, W)), ("dfa_accept", dfa_accept, (S,)),
        ("remaining", remaining, (K,)),
    ])
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("kernels", entry, bx.data_ptr(), by.data_ptr(), tx.data_ptr(),
                ty.data_ptr(), inv.data_ptr(), dfa_table.data_ptr(),
                dfa_accept.data_ptr(), W, int(start), _DFA_FMT_CODE[fmt],
                remaining.data_ptr(), out.data_ptr(), K, B, _stream(dev))
    return out


def dfa_match(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept, start,
              remaining):
    """Kernel D (``csrc/kernels.cu``): same contract as
    ``dfa_match_plain``, one launch for all K*B lanes."""
    args = (bx, by, tx, ty, inv, dfa_table, dfa_accept, start, remaining)
    tensors = args[:7] + args[8:]
    if _all_cpu(*tensors):
        return dfa_match_plain(fmt, *args)
    out = _launch_dfa("dfa_match", fmt, args)
    dfa_match.launches += 1
    return out


dfa_match.launches = 0


def glv_dfa_match(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept, start,
                  remaining):
    """Kernel E (``csrc/kernels.cu``): same contract as
    ``glv_dfa_match_plain``, one launch for all K*B lanes."""
    args = (bx, by, tx, ty, inv, dfa_table, dfa_accept, start, remaining)
    tensors = args[:7] + args[8:]
    if _all_cpu(*tensors):
        return glv_dfa_match_plain(fmt, *args)
    out = _launch_dfa("glv_dfa_match", fmt, args)
    glv_dfa_match.launches += 1
    return out


glv_dfa_match.launches = 0


# ---------------------------------------------------------------------------
# Pack tail and the steps
# ---------------------------------------------------------------------------


def pack_tail(mask: torch.Tensor, remaining: torch.Tensor,
              ops_mult: int) -> torch.Tensor:
    """(K, B) match masks -> (K, 34) int32 rows [count, ops, idx x16,
    vbits x16]: count of nonzero masks; ops = clamp(remaining, 0, B) *
    ops_mult (6 GLV keys per position, else 1, as ``_pack_tail`` counts);
    the 16 highest matching indices in descending order, -1 padded; their
    masks, 0 padded."""
    K, B = mask.shape
    idx = torch.arange(B, dtype=torch.int32, device=mask.device).expand(K, B)
    matched = mask > 0
    count = matched.sum(dim=1, dtype=torch.int32)
    scores = torch.where(matched, idx, -1)
    top = pipeline.top_k_match_indices(scores)
    vbits = torch.where(top >= 0,
                        torch.gather(mask, 1, top.clamp(min=0).long()), 0)
    ops = remaining.to(torch.int32).clamp(0, B) * ops_mult
    return torch.cat([count[:, None], ops[:, None], top, vbits],
                     dim=1).to(torch.int32)


def check_format(fmt: AddressFormat) -> None:
    if fmt not in DEVICE_FORMATS:
        raise NotImplementedError(
            f"{fmt.value}: the port's scan kernels cover "
            f"{', '.join(f.value for f in DEVICE_FORMATS)} (P2SH-P2WPKH, "
            "uncompressed P2PKH and Ethereum: ROADMAP queue 1 item 10)"
        )


def _keys_per_position(fmt: AddressFormat, glv: bool) -> int:
    return GLV_KEYS if glv and fmt != AddressFormat.P2TR else 1


def _range_mask(fmt, bx, by, tx, ty, lo, hi, remaining, glv, wt):
    check_format(fmt)
    if fmt == AddressFormat.P2TR:
        return fused_p2tr_range_mask_step(bx, by, tx, ty, lo, hi, remaining,
                                          wt)
    inv = batch_inverse_dx(bx, tx)
    match = range_glv_match if glv else range_match
    return match(bx, by, tx, ty, inv, lo, hi, remaining)


def _dfa_mask(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start, remaining,
              glv, wt):
    check_format(fmt)
    if fmt == AddressFormat.P2TR:
        return fused_p2tr_scan_mask_step(bx, by, tx, ty, dfa_table,
                                         dfa_accept, start, remaining, wt)
    inv = batch_inverse_dx(bx, tx)
    match = glv_dfa_match if glv else dfa_match
    return match(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept, start,
                 remaining)


def fused_range_scan_step(fmt, bx, by, tx, ty, lo, hi, remaining,
                          glv: bool = True, wt=None):
    """One super-step of the interval scan: bx, by (K, 8); tx, ty (8, B);
    lo, hi (n_slots, 5 words, 8 for P2TR); remaining (K,); all int32 ->
    (K, 34) int32 packed rows.  glv: kernel B and six keys per position
    (random scans), else kernel C and one (range scans).  P2TR takes the
    window table wt and runs kernels A, F, G, H, one key per position
    whatever glv says (``fused_p2tr_range_scan_step``)."""
    mask = _range_mask(fmt, bx, by, tx, ty, lo, hi, remaining, glv, wt)
    return pack_tail(mask, remaining, _keys_per_position(fmt, glv))


def fused_range_mask_step(fmt, bx, by, tx, ty, lo, hi, remaining,
                          glv: bool = True, wt=None):
    """Full-mask variant for overflow recovery (more than 16 matches in a
    window): same inputs, returns the (K, B) int32 masks."""
    return _range_mask(fmt, bx, by, tx, ty, lo, hi, remaining, glv, wt)


def fused_scan_step(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                    remaining, glv: bool = True, wt=None):
    """One super-step of the DFA scan: bx, by (K, 8); tx, ty (8, B);
    dfa_table (S, W), dfa_accept (S,) int32; start int; remaining (K,) ->
    (K, 34) int32 packed rows.  glv: kernel E and six keys per position
    (random scans), else kernel D and one (range scans).  P2TR takes the
    window table wt and runs kernels A, F, G, I, one key per position
    (``fused_p2tr_scan_step``)."""
    mask = _dfa_mask(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                     remaining, glv, wt)
    return pack_tail(mask, remaining, _keys_per_position(fmt, glv))


def fused_scan_mask_step(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                         remaining, glv: bool = True, wt=None):
    """Full-mask variant of ``fused_scan_step`` for overflow recovery."""
    return _dfa_mask(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                     remaining, glv, wt)


# ---------------------------------------------------------------------------
# P2TR: kernels F (ladder), G (chain), H and I (finishes) and their steps
# ---------------------------------------------------------------------------

TAPTWEAK_MIDSTATE = sha256.tagged_midstate("TapTweak")


def _taptweak_ladder(x, y, wt):
    """Q = P + t*G for the internal keys (x, y) ((8, N) int64): the even-Y
    key P, t = the TapTweak tagged hash of x, then 32 fixed 8-bit windows,
    window w adding table[w][byte w of t] by a lean Jacobian add (digit 0
    adds nothing; the table's d = 0 row is filler).  -> (X, Z, ok): ok is
    t < n and no add hit H == 0."""
    y = u256.select((y[0] & 1) == 0, y, field.neg(y))
    t = sha256.tagged_hash_32(TAPTWEAK_MIDSTATE, x)
    _, borrow = u256.sub(t, u256.constant(field.N_INT, t))
    ok = borrow == 1  # t < n
    wt64 = u256.to_i64(wt)  # (32, 256, 2, 8)
    X, Y = x, y
    Z = u256.constant(1, x).expand_as(x)
    for w in range(32):
        digit = (t[w // 4] >> (8 * (w % 4))) & 255
        pt = wt64[w][digit]  # (N, 2, 8)
        Xn, Yn, Zn, add_ok = curve.jacobian_add_affine_lean(
            X, Y, Z, pt[:, 0].T, pt[:, 1].T)
        nz = digit != 0
        ok = ok & (add_ok | ~nz)
        X = u256.select(nz, Xn, X)
        Y = u256.select(nz, Yn, Y)
        Z = u256.select(nz, Zn, Z)
    return X, Z, ok


def _ladder_out(X, Z, ok):
    return u256.to_i32(X), u256.to_i32(Z), ok.to(torch.int32)


def p2tr_ladder_plain(bx, by, tx, ty, inv, wt):
    """Plain version of kernel F.  bx, by (K, 8); tx, ty (8, B);
    inv (8, K*B) from kernel A; wt (32, 256, 2, 8) the window table; all
    int32 -> (X, Z (8, K*B) int32 Jacobian output keys, ok (K*B,) int32):
    the full finish B + T of lane k*B + b, then ``_taptweak_ladder``; ok
    also needs dx != 0.  Dead lanes are computed like the others and
    masked by ok."""
    K, B = bx.shape[0], tx.shape[1]
    x3, y3, valid = curve.ec_finish(*_lanes(bx, by, tx, ty, inv))
    X, Z, ok = _taptweak_ladder(x3.reshape(8, K * B), y3.reshape(8, K * B),
                                wt)
    return _ladder_out(X, Z, ok & valid.reshape(K * B))


def p2tr_ladder_affine_plain(x, y, wt):
    """Plain version of kernel F with finish=False (the counterpart of
    ``p2tr_ladder_fn``): affine internal keys x, y (8, N) int32 ->
    (X, Z (8, N), ok (N,)) int32, as ``p2tr_ladder_plain``."""
    return _ladder_out(*_taptweak_ladder(u256.to_i64(x), u256.to_i64(y), wt))


def p2tr_ladder(bx, by, tx, ty, inv, wt):
    """Kernel F (``csrc/p2tr.cu``, finish=True): same contract as
    ``p2tr_ladder_plain``, one launch for all K*B lanes."""
    if _all_cpu(bx, by, tx, ty, inv, wt):
        return p2tr_ladder_plain(bx, by, tx, ty, inv, wt)
    K, B = bx.shape[0], tx.shape[1]
    dev = _check_cuda("p2tr_ladder", [
        ("bx", bx, (K, 8)), ("by", by, (K, 8)), ("tx", tx, (8, B)),
        ("ty", ty, (8, B)), ("inv", inv, (8, K * B)),
        ("wt", wt, (32, 256, 2, 8))])
    X = torch.empty((8, K * B), dtype=torch.int32, device=dev)
    Z = torch.empty_like(X)
    ok = torch.empty((K * B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("p2tr", "p2tr_ladder", bx.data_ptr(), by.data_ptr(),
                tx.data_ptr(), ty.data_ptr(), inv.data_ptr(), wt.data_ptr(),
                X.data_ptr(), Z.data_ptr(), ok.data_ptr(), K, B, _stream(dev))
    p2tr_ladder.launches += 1
    return X, Z, ok


p2tr_ladder.launches = 0


def p2tr_ladder_affine(x, y, wt):
    """Kernel F with finish=False (``csrc/p2tr.cu``): same contract as
    ``p2tr_ladder_affine_plain``, one launch, counted on
    ``p2tr_ladder.launches`` (one kernel, two flags)."""
    if _all_cpu(x, y, wt):
        return p2tr_ladder_affine_plain(x, y, wt)
    N = x.shape[1]
    dev = _check_cuda("p2tr_ladder_affine", [
        ("x", x, (8, N)), ("y", y, (8, N)), ("wt", wt, (32, 256, 2, 8))])
    X = torch.empty((8, N), dtype=torch.int32, device=dev)
    Z = torch.empty_like(X)
    ok = torch.empty((N,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("p2tr", "p2tr_ladder_affine", x.data_ptr(), y.data_ptr(),
                wt.data_ptr(), X.data_ptr(), Z.data_ptr(), ok.data_ptr(), N,
                _stream(dev))
    p2tr_ladder.launches += 1
    return X, Z, ok


def batch_inverse_chain_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel G: values (8, N) int32 canonical -> (8, N)
    int32 canonical inverses, zero guarded to 1 (so a zero's "inverse" is
    exactly 1)."""
    v = u256.to_i64(values)
    N = v.shape[1]
    v = u256.select(u256.is_zero(v), u256.constant(1, v).expand_as(v), v)
    C = _chain_len(N)
    inv = field.batch_inverse_chain(v.reshape(8, C, N // C))
    return u256.to_i32(inv.reshape(8, N))


def batch_inverse_chain(values: torch.Tensor) -> torch.Tensor:
    """Kernel G (``csrc/p2tr.cu``): same contract as
    ``batch_inverse_chain_plain``, one launch (forward, inversion and
    backward pass)."""
    if _all_cpu(values):
        return batch_inverse_chain_plain(values)
    N = values.shape[1]
    dev = _check_cuda("batch_inverse_chain", [("values", values, (8, N))])
    out = torch.empty_like(values)
    scratch = torch.empty_like(values)
    with torch.cuda.device(dev):
        _launch("p2tr", "batch_inverse_chain", values.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), N, _chain_len(N),
                _stream(dev))
    batch_inverse_chain.launches += 1
    return out


batch_inverse_chain.launches = 0


def _p2tr_qx(X, Z, zi, ok, remaining):
    """(qx (8, K, B) int64, valid (K, B)): qx = X * zi^2, valid = ok and
    Z != 0 and b < remaining[k]."""
    K = remaining.shape[0]
    B = X.shape[1] // K
    Z64 = u256.to_i64(Z)
    qx = field.mul(u256.to_i64(X), field.square(u256.to_i64(zi)))
    valid = (ok != 0) & ~u256.is_zero(Z64)
    valid = valid.reshape(K, B) & _in_window(remaining, K, B)
    return qx.reshape(8, K, B), valid


def p2tr_finish_range_plain(X, Z, zi, ok, lo, hi, remaining):
    """Plain version of kernel H.  X, Z, zi (8, K*B); ok (K*B,); lo, hi
    (n_slots, 8) big-endian words; remaining (K,); all int32 -> (K, B) int32,
    1 where the output key's x lies in an interval, else 0 (also where ok
    is 0, Z is 0 or b >= remaining[k])."""
    qx, valid = _p2tr_qx(X, Z, zi, ok, remaining)
    hit = pipeline.in_intervals(pipeline.x_words(qx), u256.to_i64(lo),
                                u256.to_i64(hi))
    return (hit & valid).to(torch.int32)


def p2tr_finish_match_plain(X, Z, zi, ok, dfa_table, dfa_accept, start,
                            remaining):
    """Plain version of kernel I.  X, Z, zi, ok, remaining as kernel H;
    dfa_table (S, 34) and dfa_accept (S,) int32 (the pattern's P2TR
    ``DeviceDFA``); start int -> (K, B) int32, 1 where the bech32m address
    of the output key is accepted, else 0."""
    qx, valid = _p2tr_qx(X, Z, zi, ok, remaining)
    syms, length = encode.bech32m_p2tr_symbols(qx)
    hit = pipeline.dfa_walk(dfa_table, dfa_accept, start, syms, length)
    return (hit & valid).to(torch.int32)


def _finish_specs(name, X, Z, zi, ok, remaining, more):
    K = remaining.shape[0]
    N = X.shape[1]
    if K < 1 or N % K:
        raise ValueError(f"{name}: {N} lanes do not split into {K} windows")
    return _check_cuda(name, [
        ("X", X, (8, N)), ("Z", Z, (8, N)), ("zi", zi, (8, N)),
        ("ok", ok, (N,)), ("remaining", remaining, (K,))] + more), K, N // K


def p2tr_finish_range(X, Z, zi, ok, lo, hi, remaining):
    """Kernel H (``csrc/p2tr.cu``): same contract as
    ``p2tr_finish_range_plain``, one launch for all K*B lanes."""
    args = (X, Z, zi, ok, lo, hi, remaining)
    if _all_cpu(*args):
        return p2tr_finish_range_plain(*args)
    S = lo.shape[0]
    if not 1 <= S <= pipeline.MAX_INTERVALS:
        raise ValueError(f"p2tr_finish_range: {S} interval slots, expected "
                         f"1..{pipeline.MAX_INTERVALS}")
    dev, K, B = _finish_specs("p2tr_finish_range", X, Z, zi, ok, remaining,
                              [("lo", lo, (S, 8)), ("hi", hi, (S, 8))])
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("p2tr", "p2tr_finish_range", X.data_ptr(), Z.data_ptr(),
                zi.data_ptr(), ok.data_ptr(), lo.data_ptr(), hi.data_ptr(), S,
                remaining.data_ptr(), out.data_ptr(), K, B, _stream(dev))
    p2tr_finish_range.launches += 1
    return out


p2tr_finish_range.launches = 0


def p2tr_finish_match(X, Z, zi, ok, dfa_table, dfa_accept, start, remaining):
    """Kernel I (``csrc/p2tr.cu``): same contract as
    ``p2tr_finish_match_plain``, one launch for all K*B lanes."""
    tensors = (X, Z, zi, ok, dfa_table, dfa_accept, remaining)
    if _all_cpu(*tensors):
        return p2tr_finish_match_plain(X, Z, zi, ok, dfa_table, dfa_accept,
                                       start, remaining)
    S, W = dfa_table.shape
    width = pipeline.FORMAT_DFA_WIDTH[AddressFormat.P2TR]
    if W != width:
        raise ValueError(f"p2tr_finish_match: DFA width {W}, expected {width}")
    if not 0 <= int(start) < S:
        raise ValueError(f"p2tr_finish_match: start state {start} outside "
                         f"0..{S - 1}")
    dev, K, B = _finish_specs(
        "p2tr_finish_match", X, Z, zi, ok, remaining,
        [("dfa_table", dfa_table, (S, W)), ("dfa_accept", dfa_accept, (S,))])
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("p2tr", "p2tr_finish_match", X.data_ptr(), Z.data_ptr(),
                zi.data_ptr(), ok.data_ptr(), dfa_table.data_ptr(),
                dfa_accept.data_ptr(), W, int(start), remaining.data_ptr(),
                out.data_ptr(), K, B, _stream(dev))
    p2tr_finish_match.launches += 1
    return out


p2tr_finish_match.launches = 0


def _p2tr_ladder_zi(bx, by, tx, ty, wt):
    """Kernels A, F and G: (X, Z, zi, ok) of the K*B lanes (the
    counterpart of ``_p2tr_ladder_zi``).  Each call allocates its buffers;
    nothing is cached per window."""
    if wt is None:
        raise ValueError("P2TR steps need the window table wt")
    inv = batch_inverse_dx(bx, tx)
    X, Z, ok = p2tr_ladder(bx, by, tx, ty, inv, wt)
    del inv
    return X, Z, batch_inverse_chain(Z), ok


def fused_p2tr_range_mask_step(bx, by, tx, ty, lo, hi, remaining, wt):
    """Kernels A, F, G, H: bx, by (K, 8); tx, ty (8, B); lo, hi
    (n_slots, 8); remaining (K,); wt (32, 256, 2, 8); all int32 -> (K, B)
    int32 0/1 masks (overflow recovery)."""
    X, Z, zi, ok = _p2tr_ladder_zi(bx, by, tx, ty, wt)
    return p2tr_finish_range(X, Z, zi, ok, lo, hi, remaining)


def fused_p2tr_range_scan_step(bx, by, tx, ty, lo, hi, remaining, wt):
    """One super-step of the P2TR interval scan: the inputs of
    ``fused_p2tr_range_mask_step`` -> (K, 34) int32 packed rows, one key
    per position (no GLV: the tweak rebinds the key)."""
    mask = fused_p2tr_range_mask_step(bx, by, tx, ty, lo, hi, remaining, wt)
    return pack_tail(mask, remaining, 1)


def fused_p2tr_scan_mask_step(bx, by, tx, ty, dfa_table, dfa_accept, start,
                              remaining, wt):
    """Kernels A, F, G, I: bx, by (K, 8); tx, ty (8, B); dfa_table (S, 34),
    dfa_accept (S,) int32; start int; remaining (K,); wt -> (K, B) int32
    0/1 masks (overflow recovery)."""
    X, Z, zi, ok = _p2tr_ladder_zi(bx, by, tx, ty, wt)
    return p2tr_finish_match(X, Z, zi, ok, dfa_table, dfa_accept, start,
                             remaining)


def fused_p2tr_scan_step(bx, by, tx, ty, dfa_table, dfa_accept, start,
                         remaining, wt):
    """One super-step of the P2TR DFA scan -> (K, 34) int32 packed rows."""
    mask = fused_p2tr_scan_mask_step(bx, by, tx, ty, dfa_table, dfa_accept,
                                     start, remaining, wt)
    return pack_tail(mask, remaining, 1)
