"""The scan steps: five CUDA kernels and the pack tail.

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

Each kernel wrapper runs its plain PyTorch version when every tensor lies on
the CPU; for CUDA tensors it checks them and launches the kernel, or raises.
``<wrapper>.launches`` counts kernel launches (and nothing else).

Counterparts in ``vgen_tpu/ops/pallas_fused.py``: ``batch_inverse_dx_pallas``,
``fused_range_match_fn``, ``fused_match_fn``, ``_pack_tail``,
``fused_range_scan_step``, ``fused_range_mask_step``, ``fused_scan_step``
and ``fused_scan_mask_step``.
"""

from __future__ import annotations

import torch

from vgen_tpu.crypto.address import AddressFormat
from vgen_tpu_torch.ops import curve, field, pipeline, u256

# Formats whose device-checked value is hash160 of the compressed public
# key (P2WPKH hashes exactly what P2PKH hashes): the kernels serve these.
HASH160_FORMATS = (AddressFormat.P2PKH, AddressFormat.P2WPKH)

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


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {rc}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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
    from vgen_tpu_torch.csrc import build

    lib = build.load()
    out = torch.empty((8, K * B), dtype=torch.int32, device=dev)
    scratch = torch.empty_like(out)
    with torch.cuda.device(dev):
        rc = lib.vgen_batch_inverse_dx(
            bx.data_ptr(), tx.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            K, B, _chain_len(K * B), _stream(dev),
        )
    _raise_on(rc, "batch_inverse_dx")
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
    from vgen_tpu_torch.csrc import build

    lib = build.load()
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, f"vgen_{entry}")(
            bx.data_ptr(), by.data_ptr(), tx.data_ptr(), ty.data_ptr(),
            inv.data_ptr(), lo.data_ptr(), hi.data_ptr(), S,
            remaining.data_ptr(), out.data_ptr(), K, B, _stream(dev),
        )
    _raise_on(rc, entry)
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
        check_format(fmt)
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
    from vgen_tpu_torch.csrc import build

    lib = build.load()
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, f"vgen_{entry}")(
            bx.data_ptr(), by.data_ptr(), tx.data_ptr(), ty.data_ptr(),
            inv.data_ptr(), dfa_table.data_ptr(), dfa_accept.data_ptr(), W,
            int(start), _DFA_FMT_CODE[fmt], remaining.data_ptr(),
            out.data_ptr(), K, B, _stream(dev),
        )
    _raise_on(rc, entry)
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
    if fmt not in HASH160_FORMATS:
        raise NotImplementedError(
            f"{fmt.value}: the port's scan kernels cover "
            f"{', '.join(f.value for f in HASH160_FORMATS)} (P2SH-P2WPKH, "
            "uncompressed P2PKH and Ethereum: ROADMAP queue 1 item 10; "
            "P2TR: ROADMAP queue 1 item 13)"
        )


def _range_mask(fmt, bx, by, tx, ty, lo, hi, remaining, glv):
    check_format(fmt)
    inv = batch_inverse_dx(bx, tx)
    match = range_glv_match if glv else range_match
    return match(bx, by, tx, ty, inv, lo, hi, remaining)


def _dfa_mask(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start, remaining,
              glv):
    check_format(fmt)
    inv = batch_inverse_dx(bx, tx)
    match = glv_dfa_match if glv else dfa_match
    return match(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept, start,
                 remaining)


def fused_range_scan_step(fmt, bx, by, tx, ty, lo, hi, remaining,
                          glv: bool = True):
    """One super-step of the interval scan: bx, by (K, 8); tx, ty (8, B);
    lo, hi (n_slots, 5); remaining (K,); all int32 -> (K, 34) int32 packed
    rows.  glv: kernel B and six keys per position (random scans), else
    kernel C and one (range scans)."""
    mask = _range_mask(fmt, bx, by, tx, ty, lo, hi, remaining, glv)
    return pack_tail(mask, remaining, GLV_KEYS if glv else 1)


def fused_range_mask_step(fmt, bx, by, tx, ty, lo, hi, remaining,
                          glv: bool = True):
    """Full-mask variant for overflow recovery (more than 16 matches in a
    window): same inputs, returns the (K, B) int32 masks."""
    return _range_mask(fmt, bx, by, tx, ty, lo, hi, remaining, glv)


def fused_scan_step(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                    remaining, glv: bool = True):
    """One super-step of the DFA scan: bx, by (K, 8); tx, ty (8, B);
    dfa_table (S, W), dfa_accept (S,) int32; start int; remaining (K,) ->
    (K, 34) int32 packed rows.  glv: kernel E and six keys per position
    (random scans), else kernel D and one (range scans)."""
    mask = _dfa_mask(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                     remaining, glv)
    return pack_tail(mask, remaining, GLV_KEYS if glv else 1)


def fused_scan_mask_step(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                         remaining, glv: bool = True):
    """Full-mask variant of ``fused_scan_step`` for overflow recovery."""
    return _dfa_mask(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                     remaining, glv)
