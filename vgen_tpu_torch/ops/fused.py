"""The scan steps: nine CUDA kernels and the pack tail; and the two table
kernels.

One super-step covers K windows of B keys.  Window k adds its base point
(bx[k], by[k]) = base_k * G to every table point i*G, i = 1..B:

1. kernel A, ``batch_inverse_dx``: canonical inverses of dx = tx[b] - bx[k]
   for all K*B lanes, one Montgomery batch inversion;
2. one match kernel over all K*B lanes, for the format ``fmt`` (one of the
   five hash formats, each hashing the point into 5 big-endian "value"
   words: hash160 of the compressed key, of its P2SH-P2WPKH redeem script,
   of the uncompressed key, or the Ethereum account):
   - B, ``range_glv_match``: the finish, x * beta^v, six variants' values,
     interval compare -> a 6-bit GLV variant mask (random interval scans);
   - C, ``range_match``: full finish, one value, interval compare -> 0/1
     (range interval scans);
   - D, ``dfa_match``: full finish, the value, address symbols, DFA walk ->
     0/1 (range scans of any other regex);
   - E, ``glv_dfa_match``: the finish, the six variants through symbols and
     the DFA -> a 6-bit mask (random scans of any other regex).
   The compressed-key formats' variants are the two prefix parities of
   each beta^v x (x-only finish); the GLV_EXACT_Y formats (uncompressed,
   Ethereum) hash (beta^v x, +-y) (full finish).  All five formats' instances
   live in ``csrc/kernels.cu``;
3. ``pack_tail`` (PyTorch ops): one (K, 34) int32 row per window,
   [count, ops, 16 highest matching indices, their masks].

P2TR (no GLV: the tweak rebinds the key) runs four more kernels between
kernel A and the pack (``csrc/p2tr.cu``):

- F, ``p2tr_ladder``: full finish, even-Y internal key, TapTweak tagged
  hash t, Q = P + t*G by fixed windows of lean Jacobian adds (the window
  schedule is the table's: ``LADDER_WINDOW`` in the product, the 8-bit
  table of the JAX package too) -> X, Z (8, K*B) and ok (K*B,);
- G, ``batch_inverse_chain``: canonical inverses of Z, zero guarded to 1;
- H, ``p2tr_finish_range``: qx = X * zi^2, 8-word interval compare -> 0/1;
- I, ``p2tr_finish_match``: qx, bech32m symbols, DFA walk -> 0/1.

The i*G table and the P2TR ladder table are built on the card by two more
kernels (``csrc/tables.cu``) around kernel G: T1, ``table_grow``, the
log-doubling steps of rows of multiples in Jacobian coordinates; G on their
Z; T2, ``table_affine``, the affine pass into the consumer's layout
(``scan/tables.py`` ``build_multiples``).

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

# The formats kernels B to E serve, each hashing the point into a 5-word
# value (P2WPKH hashes exactly what P2PKH hashes), with the kernels' format
# argument (csrc/dfa.cuh kFmtP2PKH ... kFmtEthereum)
FMT_CODE = {
    AddressFormat.P2PKH: 0,
    AddressFormat.P2WPKH: 1,
    AddressFormat.P2SH_P2WPKH: 2,
    AddressFormat.P2PKH_UNCOMPRESSED: 3,
    AddressFormat.ETHEREUM: 4,
}
# ... and P2TR, through kernels F to I: the formats the port scans on a device
DEVICE_FORMATS = tuple(FMT_CODE) + (AddressFormat.P2TR,)

GLV_KEYS = 6  # keys checked per table position: {+-k, +-lk, +-l^2 k}

# elements per thread chain of the plain batch inversions (the largest
# power of two <= this that divides the lane count)
INV_CHAIN = 64
# kernels A and G: (M, G), each thread a chain of M elements (the largest
# power of two <= M that divides the lane count), G threads of a block
# sharing one inversion (csrc/inv_block.cuh); (64, 1) is one inversion per
# thread.  Chosen on the card by ``python -m
# vgen_tpu_torch.probes.sweep_inv_chain``.
INV_GEOMETRY = (64, 256)
INV_GROUPS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

# kernel F's window schedules (bits, signed digits) that csrc/p2tr.cu
# instances (VG_LADDER_WINDOWS), and the product's, chosen on the card by
# ``python -m vgen_tpu_torch.probes.sweep_ladder_window``
LADDER_WINDOWS = ((8, False), (12, False), (13, False), (14, False),
                  (13, True), (14, True), (15, True), (16, True))
LADDER_WINDOW = (16, True)


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


def _inv_geometry(n: int, chain: int, group: int):
    if group not in INV_GROUPS:
        raise ValueError(f"inversion group {group}: expected one of "
                         f"{INV_GROUPS}")
    return _chain_len(n, chain), group


def batch_inverse_dx(bx: torch.Tensor, tx: torch.Tensor,
                     chain: int = INV_GEOMETRY[0],
                     group: int = INV_GEOMETRY[1]) -> torch.Tensor:
    """Kernel A (``csrc/kernels.cu``): same contract as
    ``batch_inverse_dx_plain``, one launch for all K*B lanes, each thread
    a chain of the largest power of two <= ``chain`` that divides K*B,
    ``group`` threads sharing one inversion (the output is canonical, so
    the geometry changes no value)."""
    if _all_cpu(bx, tx):
        return batch_inverse_dx_plain(bx, tx)
    K, B = bx.shape[0], tx.shape[1]
    m, g = _inv_geometry(K * B, chain, group)
    dev = _check_cuda("batch_inverse_dx", [("bx", bx, (K, 8)),
                                           ("tx", tx, (8, B))])
    out = torch.empty((8, K * B), dtype=torch.int32, device=dev)
    scratch = torch.empty_like(out)
    with torch.cuda.device(dev):
        _launch("kernels", "batch_inverse_dx", bx.data_ptr(), tx.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), K, B, m, g, _stream(dev))
    batch_inverse_dx.launches += 1
    return out


batch_inverse_dx.launches = 0


# ---------------------------------------------------------------------------
# Kernels B and C: the value(s) of each lane against the intervals
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


def _full_finish(bx, by, tx, ty, inv, remaining):
    """(x3, y3, valid) of the full finish (kernels C and D); valid masks
    dx == 0 and b >= remaining[k]."""
    K, B = bx.shape[0], tx.shape[1]
    x3, y3, valid = curve.ec_finish(*_lanes(bx, by, tx, ty, inv))
    return x3, y3, valid & _in_window(remaining, K, B)


def _glv_finish(fmt, bx, by, tx, ty, inv, remaining):
    """(x3, y3, valid) for kernels B and E: the full finish for the
    GLV_EXACT_Y formats, the x-only one (y3 None) for the others."""
    if fmt in pipeline.GLV_EXACT_Y:
        return _full_finish(bx, by, tx, ty, inv, remaining)
    K, B = bx.shape[0], tx.shape[1]
    x3, valid = curve.ec_finish_x(*_lanes(bx, by, tx, ty, inv))
    return x3, None, valid & _in_window(remaining, K, B)


def range_glv_match_plain(fmt, bx, by, tx, ty, inv, lo, hi, remaining):
    """Plain version of kernel B.  bx, by (K, 8); tx, ty (8, B);
    inv (8, K*B); lo, hi (n_slots, 5); remaining (K,); all int32 ->
    (K, B) int32 mask, bit 2v+pi set when the value of variant (beta^v x,
    pi) lies in an interval (``pipeline.glv_interval_mask``); 0 where
    dx == 0 or b >= remaining[k]."""
    x3, y3, valid = _glv_finish(fmt, bx, by, tx, ty, inv, remaining)
    mask = pipeline.glv_interval_mask(fmt, x3, y3, u256.to_i64(lo),
                                      u256.to_i64(hi))
    return torch.where(valid, mask, 0).to(torch.int32)


def _match_code(name: str, fmt) -> int:
    if fmt not in FMT_CODE:
        check_format(fmt)
        raise ValueError(f"{name}: kernels B to E serve the hash formats; "
                         f"{fmt.value} scans through kernels F to I")
    return FMT_CODE[fmt]


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


def _launch_interval(entry: str, fmt, args):
    """Launch kernel B or C (same C signature) -> (K, B) int32."""
    code = _match_code(entry, fmt)
    bx, by, tx, ty, inv, lo, hi, remaining = args
    K, B, S = bx.shape[0], tx.shape[1], lo.shape[0]
    dev = _interval_specs(entry, *args)
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("kernels", entry, code, bx.data_ptr(), by.data_ptr(),
                tx.data_ptr(), ty.data_ptr(), inv.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), S, remaining.data_ptr(), out.data_ptr(), K, B,
                _stream(dev))
    return out


def range_glv_match(fmt, bx, by, tx, ty, inv, lo, hi, remaining):
    """Kernel B (``csrc/kernels.cu``): same contract
    as ``range_glv_match_plain``, one launch for all K*B lanes."""
    args = (bx, by, tx, ty, inv, lo, hi, remaining)
    if _all_cpu(*args):
        return range_glv_match_plain(fmt, *args)
    out = _launch_interval("range_glv_match", fmt, args)
    range_glv_match.launches += 1
    return out


range_glv_match.launches = 0


def range_match_plain(fmt, bx, by, tx, ty, inv, lo, hi, remaining):
    """Plain version of kernel C.  Same inputs as kernel B -> (K, B) int32,
    1 where the value of B + T (``pipeline.interval_value_words``) lies in
    an interval, else 0; 0 where dx == 0 or b >= remaining[k]."""
    x3, y3, valid = _full_finish(bx, by, tx, ty, inv, remaining)
    hit = pipeline.in_intervals(pipeline.interval_value_words(fmt, x3, y3),
                                u256.to_i64(lo), u256.to_i64(hi))
    return (hit & valid).to(torch.int32)


def range_match(fmt, bx, by, tx, ty, inv, lo, hi, remaining):
    """Kernel C (``csrc/kernels.cu``): same contract
    as ``range_match_plain``, one launch for all K*B lanes."""
    args = (bx, by, tx, ty, inv, lo, hi, remaining)
    if _all_cpu(*args):
        return range_match_plain(fmt, *args)
    out = _launch_interval("range_match", fmt, args)
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
    x3, y3, valid = _full_finish(bx, by, tx, ty, inv, remaining)
    hit = pipeline.dfa_matches(fmt, pipeline.interval_value_words(fmt, x3, y3),
                               dfa_table, dfa_accept, start)
    return (hit & valid).to(torch.int32)


def glv_dfa_match_plain(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept,
                        start, remaining):
    """Plain version of kernel E.  Same inputs as kernel D -> (K, B) int32
    6-bit masks, bit 2v+pi set when the address of variant (beta^v x, pi)
    is accepted (the bit layout of kernel B); 0 where dx == 0 or
    b >= remaining[k]."""
    x3, y3, valid = _glv_finish(fmt, bx, by, tx, ty, inv, remaining)
    mask = pipeline.glv_dfa_mask(fmt, x3, y3, dfa_table, dfa_accept, start)
    return torch.where(valid, mask, 0).to(torch.int32)


# Kernel D's and I's table forms (csrc/dfa.cuh with_dfa_table): "shared",
# the narrow table (uint16 entries, uint8 accept flags) copied into each
# block's shared memory, for a table of at most DFA_SHARED_MAX bytes;
# "global", the int32 table through the read-only cache, for any.  Both
# kernels take the shared form up to DFA_SHARED_BUDGET bytes, at every
# width: D read 1.8-5% faster than the global form on [Cc]at for the
# Base58Check formats and P2WPKH, a tie for Ethereum, up to 0.7% faster
# at 128 states (15.5 KB) and 1% slower at 270 (32 KB) (``python -m
# vgen_tpu_torch.probes.profile_dfa``, two runs); I read 0.71-0.81 of the
# global form's time up to 237 states (16 KB) at width 34 (``python -m
# vgen_tpu_torch.probes.profile_p2tr_match``, two runs; NVIDIA H100 80GB
# HBM3, 700 W; PERF.md)
DFA_SHARED_MAX = 32768
DFA_SHARED_BUDGET = 16384
DFA_FORMS = ("shared", "global")
NARROW_MAX_STATES = 1 << 16


def _narrow_bytes(n_states: int, width: int) -> int:
    return n_states * width * 2 + n_states


def dfa_form(n_states: int, width: int) -> str:
    """The table form kernels D and I take for an (n_states, width) DFA:
    shared where its narrow form fits DFA_SHARED_BUDGET bytes, else
    global."""
    fits = _narrow_bytes(n_states, width) <= DFA_SHARED_BUDGET
    return "shared" if fits and n_states <= NARROW_MAX_STATES else "global"


def narrow_dfa(dfa_table: torch.Tensor, dfa_accept: torch.Tensor):
    """The narrow form of a DFA: (S, W) int32 table -> (S, W) int16 holding
    the uint16 state numbers, (S,) accept -> (S,) uint8 0/1, on the table's
    device.  More than 65,536 states raises ValueError."""
    S = dfa_table.shape[0]
    if S > NARROW_MAX_STATES:
        raise ValueError(f"narrow_dfa: {S} states, the narrow form holds at "
                         f"most {NARROW_MAX_STATES}")
    # int16 holds each uint16 state number's bits (two's complement)
    v = dfa_table.to(torch.int32) & 0xFFFF
    table = torch.where(v >= 1 << 15, v - (1 << 16), v).to(torch.int16)
    return table, (dfa_accept != 0).to(torch.uint8).contiguous()


def _check_dfa_inputs(entry: str, fmt, args):
    """Check kernel D's or E's inputs -> (format code, device)."""
    code = _match_code(entry, fmt)
    bx, by, tx, ty, inv, dfa_table, dfa_accept, start, remaining = args
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
    return code, dev


def _launch_glv_dfa(fmt, args):
    """Check kernel E's inputs and launch it."""
    code, dev = _check_dfa_inputs("glv_dfa_match", fmt, args)
    bx, by, tx, ty, inv, dfa_table, dfa_accept, start, remaining = args
    K, B, W = bx.shape[0], tx.shape[1], dfa_table.shape[1]
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("kernels", "glv_dfa_match", bx.data_ptr(), by.data_ptr(),
                tx.data_ptr(), ty.data_ptr(), inv.data_ptr(),
                dfa_table.data_ptr(), dfa_accept.data_ptr(), W, int(start),
                code, remaining.data_ptr(), out.data_ptr(), K, B,
                _stream(dev))
    return out


def _table_form(entry: str, dfa_table, dfa_accept, narrow, form, dev):
    """Kernel D's or I's table form and the tensors it reads ->
    (table, accept, form): ``form`` or ``dfa_form``'s choice ("shared"
    raises for a table over DFA_SHARED_MAX bytes); the shared
    form reads ``narrow`` (the table's ``narrow_dfa``) or builds it."""
    S, W = dfa_table.shape
    if form is None:
        form = dfa_form(S, W)
    elif form not in DFA_FORMS:
        raise ValueError(f"{entry}: table form {form!r}, expected one of "
                         f"{DFA_FORMS}")
    elif form == "shared" and _narrow_bytes(S, W) > DFA_SHARED_MAX:
        raise ValueError(f"{entry}: a ({S}, {W}) table is over the shared "
                         f"form's {DFA_SHARED_MAX} bytes")
    if form == "global":
        return dfa_table, dfa_accept, form
    table, accept = narrow if narrow is not None else narrow_dfa(
        dfa_table, dfa_accept)
    for arg, t, dtype, shape in (("narrow table", table, torch.int16, (S, W)),
                                 ("narrow accept", accept, torch.uint8,
                                  (S,))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 4):
            raise ValueError(f"{entry}: {arg} must be a contiguous, 4-byte "
                             f"aligned {shape} {dtype} tensor on {dev}")
    return table, accept, form


def _launch_dfa_match(fmt, args, narrow, form):
    """Check kernel D's inputs, choose its table form and launch it ->
    ((K, B) int32, the form)."""
    code, dev = _check_dfa_inputs("dfa_match", fmt, args)
    bx, by, tx, ty, inv, dfa_table, dfa_accept, start, remaining = args
    K, B = bx.shape[0], tx.shape[1]
    S, W = dfa_table.shape
    table, accept, form = _table_form("dfa_match", dfa_table, dfa_accept,
                                      narrow, form, dev)
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("kernels", "dfa_match", int(form == "shared"), bx.data_ptr(),
                by.data_ptr(), tx.data_ptr(), ty.data_ptr(), inv.data_ptr(),
                table.data_ptr(), accept.data_ptr(), S, W, int(start), code,
                remaining.data_ptr(), out.data_ptr(), K, B, _stream(dev))
    return out, form


def dfa_match(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept, start,
              remaining, narrow=None, form=None):
    """Kernel D (``csrc/kernels.cu``): same contract as ``dfa_match_plain``,
    one launch for all K*B lanes.  The table form is ``dfa_form``'s
    unless ``form`` names one ("shared" raises for a table over
    DFA_SHARED_MAX bytes); the shared form reads ``narrow`` (``narrow_dfa`` of the
    table, which the scanner builds once per pattern) or builds it.
    ``dfa_match.launches`` counts launches, ``dfa_match.forms`` those of
    each form."""
    args = (bx, by, tx, ty, inv, dfa_table, dfa_accept, start, remaining)
    tensors = args[:7] + args[8:]
    if _all_cpu(*tensors):
        return dfa_match_plain(fmt, *args)
    out, used = _launch_dfa_match(fmt, args, narrow, form)
    dfa_match.launches += 1
    dfa_match.forms[used] += 1
    return out


dfa_match.launches = 0
dfa_match.forms = dict.fromkeys(DFA_FORMS, 0)


def glv_dfa_match(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept, start,
                  remaining):
    """Kernel E (``csrc/kernels.cu``): same contract
    as ``glv_dfa_match_plain``, one launch for all K*B lanes."""
    args = (bx, by, tx, ty, inv, dfa_table, dfa_accept, start, remaining)
    tensors = args[:7] + args[8:]
    if _all_cpu(*tensors):
        return glv_dfa_match_plain(fmt, *args)
    out = _launch_glv_dfa(fmt, args)
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


def check_format(fmt) -> None:
    """Raise for anything that is not an address format the kernels scan
    (all six are)."""
    if fmt not in DEVICE_FORMATS:
        raise ValueError(f"{fmt!r}: the port's scan kernels cover "
                         f"{', '.join(f.value for f in DEVICE_FORMATS)}")


def _keys_per_position(fmt: AddressFormat, glv: bool) -> int:
    return GLV_KEYS if glv and fmt != AddressFormat.P2TR else 1


def _range_mask(fmt, bx, by, tx, ty, lo, hi, remaining, glv, wt):
    check_format(fmt)
    if fmt == AddressFormat.P2TR:
        return fused_p2tr_range_mask_step(bx, by, tx, ty, lo, hi, remaining,
                                          wt)
    inv = batch_inverse_dx(bx, tx)
    match = range_glv_match if glv else range_match
    return match(fmt, bx, by, tx, ty, inv, lo, hi, remaining)


def _dfa_mask(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start, remaining,
              glv, wt, narrow=None):
    check_format(fmt)
    if fmt == AddressFormat.P2TR:
        return fused_p2tr_scan_mask_step(bx, by, tx, ty, dfa_table,
                                         dfa_accept, start, remaining, wt,
                                         narrow)
    inv = batch_inverse_dx(bx, tx)
    if glv:
        return glv_dfa_match(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept,
                             start, remaining)
    return dfa_match(fmt, bx, by, tx, ty, inv, dfa_table, dfa_accept, start,
                     remaining, narrow=narrow)


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
                    remaining, glv: bool = True, wt=None, narrow=None):
    """One super-step of the DFA scan: bx, by (K, 8); tx, ty (8, B);
    dfa_table (S, W), dfa_accept (S,) int32; start int; remaining (K,) ->
    (K, 34) int32 packed rows.  glv: kernel E and six keys per position
    (random scans), else kernel D and one (range scans).  P2TR takes the
    window table wt and runs kernels A, F, G, I, one key per position
    (``fused_p2tr_scan_step``).  ``narrow`` is the table's ``narrow_dfa``
    for kernel D or I, or None to build it where the kernel takes the
    shared form."""
    mask = _dfa_mask(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                     remaining, glv, wt, narrow)
    return pack_tail(mask, remaining, _keys_per_position(fmt, glv))


def fused_scan_mask_step(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                         remaining, glv: bool = True, wt=None, narrow=None):
    """Full-mask variant of ``fused_scan_step`` for overflow recovery."""
    return _dfa_mask(fmt, bx, by, tx, ty, dfa_table, dfa_accept, start,
                     remaining, glv, wt, narrow)


# ---------------------------------------------------------------------------
# P2TR: kernels F (ladder), G (chain), H and I (finishes) and their steps
# ---------------------------------------------------------------------------

TAPTWEAK_MIDSTATE = sha256.tagged_midstate("TapTweak")


def ladder_shape(bits: int, signed: bool):
    """(windows, entries) of the ladder table for digits of ``bits`` bits
    (``csrc/p2tr_lanes.cuh`` LadderWindows): unsigned, ceil(256 / bits)
    windows of 2^bits entries; signed, ceil(257 / bits) windows of
    2^(bits-1) + 1 (|d|; the last digit has room for the recoding's
    carry)."""
    if signed:
        return -(-257 // bits), (1 << (bits - 1)) + 1
    return -(-256 // bits), 1 << bits


def ladder_schedule(wt: torch.Tensor):
    """(bits, signed) of a ladder table, read from its shape (windows,
    entries, 2, 8): 2^bits entries are unsigned digits, 2^(bits-1) + 1
    signed ones."""
    if wt.dim() != 4 or tuple(wt.shape[2:]) != (2, 8):
        raise ValueError(f"ladder table of shape {tuple(wt.shape)}, expected "
                         "(windows, entries, 2, 8)")
    windows, entries = wt.shape[:2]
    signed = entries & (entries - 1) != 0
    bits = (entries - 1).bit_length()
    if not 2 <= bits <= 31 or ladder_shape(bits, signed) != (windows,
                                                             entries):
        raise ValueError(f"ladder table of shape {tuple(wt.shape)} is no "
                         "window schedule")
    return bits, signed


def ladder_digits(t, bits: int, signed: bool):
    """The digits of t ((8, N) int64 32-bit limbs) in the ladder's order,
    least significant first: [(|d|, negative)] of (N,) int64 and bool,
    one per window (``csrc/p2tr_lanes.cuh`` ladder_digit)."""
    windows, _ = ladder_shape(bits, signed)
    mask, half = (1 << bits) - 1, 1 << (bits - 1)
    carry = torch.zeros_like(t[0])
    out = []
    for w in range(windows):
        limb, off = divmod(bits * w, 32)
        v = t[limb] >> off if limb < 8 else torch.zeros_like(t[0])
        if off + bits > 32 and limb + 1 < 8:
            v = v | (t[limb + 1] << (32 - off))
        d = (v & mask) + carry
        if signed:
            neg = d > half
            carry = neg.to(torch.int64)
            d = torch.where(neg, (1 << bits) - d, d)
            neg = neg & (d != 0)
        else:
            neg = torch.zeros_like(d, dtype=torch.bool)
        out.append((d, neg))
    return out


def _taptweak_ladder(x, y, wt):
    """Q = P + t*G for the internal keys (x, y) ((8, N) int64): the even-Y
    key P, t = the TapTweak tagged hash of x, then the table's windows
    (``ladder_schedule``), window w adding table[w][|digit w|], negated
    for a negative digit, by a lean Jacobian add (digit 0 adds nothing;
    the table's d = 0 row is filler).  Every add is exact: where the lean
    add meets H == 0 the sum is the entry's double (``affine_double``) or
    the point at infinity (Z = 0, which the next entry replaces).  -> (X,
    Z, ok): ok is t < n and Q not at infinity."""
    bits, signed = ladder_schedule(wt)
    y = u256.select((y[0] & 1) == 0, y, field.neg(y))
    t = sha256.tagged_hash_32(TAPTWEAK_MIDSTATE, x)
    _, borrow = u256.sub(t, u256.constant(field.N_INT, t))
    ok = borrow == 1  # t < n
    wt64 = u256.to_i64(wt)  # (windows, entries, 2, 8)
    X, Y = x, y
    Z = one = u256.constant(1, x).expand_as(x)
    for w, (digit, neg) in enumerate(ladder_digits(t, bits, signed)):
        pt = wt64[w][digit]  # (N, 2, 8)
        px, py = pt[:, 0].T, pt[:, 1].T
        py = u256.select(neg, field.neg(py), py)
        Xn, Yn, Zn, add_ok = curve.jacobian_add_affine_lean(X, Y, Z, px, py)
        # H == 0 left Zn = 0 and Xn = r^2: r == 0 doubles the entry, else
        # the sum is the point at infinity (Zn = 0)
        dbl = ~add_ok & u256.is_zero(Xn)
        if bool(dbl.any()):
            Xd, Yd, Zd = curve.affine_double(px, py)
            Xn, Yn, Zn = (u256.select(dbl, d, n)
                          for d, n in ((Xd, Xn), (Yd, Yn), (Zd, Zn)))
        inf = u256.is_zero(Z)  # from infinity: the sum is the entry
        Xn, Yn, Zn = (u256.select(inf, e, n)
                      for e, n in ((px, Xn), (py, Yn), (one, Zn)))
        nz = digit != 0
        X = u256.select(nz, Xn, X)
        Y = u256.select(nz, Yn, Y)
        Z = u256.select(nz, Zn, Z)
    return X, Z, ok & ~u256.is_zero(Z)


def _ladder_out(X, Z, ok):
    return u256.to_i32(X), u256.to_i32(Z), ok.to(torch.int32)


def p2tr_ladder_plain(bx, by, tx, ty, inv, wt):
    """Plain version of kernel F.  bx, by (K, 8); tx, ty (8, B);
    inv (8, K*B) from kernel A; wt (windows, entries, 2, 8) a ladder table
    (``scan.tables.ladder_table``, or the 8-bit ``window_table``); all
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


def _kernel_schedule(name: str, wt):
    bits, signed = ladder_schedule(wt)
    if (bits, signed) not in LADDER_WINDOWS:
        raise ValueError(f"{name}: no kernel instance for {bits}-bit "
                         f"{'signed' if signed else 'unsigned'} digits; "
                         f"csrc/p2tr.cu has {LADDER_WINDOWS}")
    return bits, signed


def p2tr_ladder(bx, by, tx, ty, inv, wt):
    """Kernel F (``csrc/p2tr.cu``, finish=True): same contract as
    ``p2tr_ladder_plain``, one launch for all K*B lanes, the instance of
    the table's window schedule."""
    if _all_cpu(bx, by, tx, ty, inv, wt):
        return p2tr_ladder_plain(bx, by, tx, ty, inv, wt)
    K, B = bx.shape[0], tx.shape[1]
    bits, signed = _kernel_schedule("p2tr_ladder", wt)
    dev = _check_cuda("p2tr_ladder", [
        ("bx", bx, (K, 8)), ("by", by, (K, 8)), ("tx", tx, (8, B)),
        ("ty", ty, (8, B)), ("inv", inv, (8, K * B)),
        ("wt", wt, tuple(wt.shape))])
    X = torch.empty((8, K * B), dtype=torch.int32, device=dev)
    Z = torch.empty_like(X)
    ok = torch.empty((K * B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("p2tr", "p2tr_ladder", bx.data_ptr(), by.data_ptr(),
                tx.data_ptr(), ty.data_ptr(), inv.data_ptr(), wt.data_ptr(),
                X.data_ptr(), Z.data_ptr(), ok.data_ptr(), K, B, bits,
                int(signed), _stream(dev))
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
    bits, signed = _kernel_schedule("p2tr_ladder_affine", wt)
    dev = _check_cuda("p2tr_ladder_affine", [
        ("x", x, (8, N)), ("y", y, (8, N)), ("wt", wt, tuple(wt.shape))])
    X = torch.empty((8, N), dtype=torch.int32, device=dev)
    Z = torch.empty_like(X)
    ok = torch.empty((N,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("p2tr", "p2tr_ladder_affine", x.data_ptr(), y.data_ptr(),
                wt.data_ptr(), X.data_ptr(), Z.data_ptr(), ok.data_ptr(), N,
                bits, int(signed), _stream(dev))
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


def batch_inverse_chain(values: torch.Tensor, chain: int = INV_GEOMETRY[0],
                        group: int = INV_GEOMETRY[1]) -> torch.Tensor:
    """Kernel G (``csrc/p2tr.cu``): same contract as
    ``batch_inverse_chain_plain``, one launch (forward, the group's
    inversion and backward pass) in kernel A's geometry (``chain``,
    ``group``)."""
    if _all_cpu(values):
        return batch_inverse_chain_plain(values)
    N = values.shape[1]
    m, g = _inv_geometry(N, chain, group)
    dev = _check_cuda("batch_inverse_chain", [("values", values, (8, N))])
    out = torch.empty_like(values)
    scratch = torch.empty_like(values)
    with torch.cuda.device(dev):
        _launch("p2tr", "batch_inverse_chain", values.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), N, m, g, _stream(dev))
    batch_inverse_chain.launches += 1
    return out


batch_inverse_chain.launches = 0


# ---------------------------------------------------------------------------
# The table kernels: T1 (log-doubling steps) and T2 (the affine pass)
# ---------------------------------------------------------------------------

# kernel G's (M, G) on a table's Z, (8, R count): the product's (64, 256)
# gives 8192 threads at the i*G table's 524288 points, 32 blocks on 132
# SMs.  Chosen on the card by ``python -m vgen_tpu_torch.probes.sweep_inv_chain
# --n 524288 557056`` (the i*G table, the 16-bit ladder table): (16, 256)
# read 0.190 and 0.203 ms, (64, 256) 0.309 and 0.312; (8, 256), 0.176 at
# 524288, took 0.352 at 557056, whose 272 blocks of 96-register threads
# overflow one wave of two blocks per SM (NVIDIA H100 80GB HBM3, 700 W).
TABLE_INV_GEOMETRY = (16, 256)
# T1's threads a block, passed to its launcher: the steps of at most this
# many columns a row run in one launch of one block per row
TABLE_GROW_BLOCK = 256


def table_steps(count: int) -> int:
    """The log-doubling steps of ``count`` columns, ceil(log2 count), at
    least 1: the base points 2^s P a row needs, s < steps."""
    return max((count - 1).bit_length(), 1)


def table_launches(count: int):
    """T1's launches for ``count`` columns, as [(s0, s1)] step ranges: the
    steps of at most ``TABLE_GROW_BLOCK`` columns in one block per row, then
    one launch per step."""
    steps = table_steps(count)
    first = min(steps, TABLE_GROW_BLOCK.bit_length())
    return [(0, first)] + [(s, s + 1) for s in range(first, steps)]


def _table_rows(name: str, bases: torch.Tensor, count: int) -> int:
    if count < 1:
        raise ValueError(f"{name}: {count} columns, expected at least 1")
    steps = table_steps(count)
    if bases.dim() != 4 or tuple(bases.shape[1:]) != (steps, 2, 8):
        raise ValueError(f"{name}: bases of shape {tuple(bases.shape)}, "
                         f"expected (rows, {steps}, 2, 8) for {count} columns")
    return bases.shape[0]


def _check_infinities(name: str, n: int) -> None:
    """Kernel G guards a zero Z to 1, which would turn a lane at infinity
    into a wrong point without a word: refuse the table instead."""
    if n:
        raise ValueError(f"{name}: {n} lanes met the point at infinity (a "
                         "base is not 2^s P of its row, or a row wraps the "
                         "group order)")


def table_grow_plain(bases: torch.Tensor, count: int):
    """Plain version of kernel T1 over all of a table's steps.  bases
    (R, steps, 2, 8) int32, the affine 2^s P_r of each row (steps =
    ``table_steps(count)``) -> (X, Y, Z) (8, R count) int32 Jacobian, column
    c of row r at r count + c holding (c + 1) P_r: column 0 is P_r (Z = 1),
    and step s (n = 2^s) makes column n + i = column i + 2^s P_r for i <
    min(n, count - n) by ``curve.jacobian_add_affine`` (its doubling where
    i = n - 1).  Raises ValueError where an add met the point at
    infinity."""
    R = _table_rows("table_grow", bases, count)
    b = u256.to_i64(bases)
    X, Y, Z = (torch.zeros((8, R, count), dtype=torch.int64,
                           device=bases.device) for _ in range(3))
    X[:, :, 0], Y[:, :, 0], Z[0, :, 0] = b[:, 0, 0].T, b[:, 0, 1].T, 1
    infinities = 0
    for s in range(table_steps(count)):
        n = 1 << s
        w = min(n, count - n)
        if w <= 0:
            continue
        x2, y2 = (b[:, s, c].T.reshape(8, R, 1).expand(8, R, w)
                  for c in (0, 1))
        Xn, Yn, Zn = curve.jacobian_add_affine(X[:, :, :w], Y[:, :, :w],
                                               Z[:, :, :w], x2, y2)
        # P == -Q: Z3 = 0 from a finite P
        infinities += int((u256.is_zero(Zn)
                           & ~u256.is_zero(Z[:, :, :w])).sum())
        X[:, :, n:n + w], Y[:, :, n:n + w], Z[:, :, n:n + w] = Xn, Yn, Zn
    _check_infinities("table_grow", infinities)
    return tuple(u256.to_i32(t.reshape(8, R * count)) for t in (X, Y, Z))


def table_grow(bases: torch.Tensor, count: int):
    """Kernel T1 (``csrc/tables.cu``): same contract as
    ``table_grow_plain``, in the launches of ``table_launches`` (at most
    ceil(log2 count)), the Jacobian arrays updated in place; the lanes
    that met infinity are counted on the card and read once at the end
    (one synchronisation)."""
    if _all_cpu(bases):
        return table_grow_plain(bases, count)
    R = _table_rows("table_grow", bases, count)
    steps = bases.shape[1]
    dev = _check_cuda("table_grow", [("bases", bases, (R, steps, 2, 8))])
    X, Y, Z = (torch.empty((8, R * count), dtype=torch.int32, device=dev)
               for _ in range(3))
    infinities = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        for s0, s1 in table_launches(count):
            _launch("tables", "table_grow", X.data_ptr(), Y.data_ptr(),
                    Z.data_ptr(), bases.data_ptr(), infinities.data_ptr(), R,
                    count, steps, s0, s1, TABLE_GROW_BLOCK, _stream(dev))
            table_grow.launches += 1
    _check_infinities("table_grow", int(infinities.item()))
    return X, Y, Z


table_grow.launches = 0


def _affine_shape(X, rows: int, ladder: bool):
    """(N, count) of T2's (8, N) inputs in ``rows`` rows."""
    N = X.shape[1]
    if rows < 1 or N == 0 or N % rows:
        raise ValueError(f"table_affine: {N} columns do not split into "
                         f"{rows} rows")
    if not ladder and rows != 1:
        raise ValueError("table_affine: the i*G layout has one row")
    return N, N // rows


def table_affine_plain(X, Y, zi, rows: int, ladder: bool):
    """Plain version of kernel T2.  X, Y, zi (8, R count) int32 (zi = 1 / Z
    from kernel G, R = ``rows``) -> the affine (x, y) = (X zi^2, Y zi^3) in
    the consumer's layout: ladder False, (tx, ty) (8, count) int32 (R = 1,
    the i*G table); ladder True, the ladder table (R, count + 1, 2, 8)
    int32, entry [r][c + 1] = column c of row r, the d = 0 rows zero."""
    N, count = _affine_shape(X, rows, ladder)
    z = u256.to_i64(zi)
    zi2 = field.square(z)
    x = field.mul(u256.to_i64(X), zi2)
    y = field.mul(u256.to_i64(Y), field.mul(zi2, z))
    if not ladder:
        return u256.to_i32(x), u256.to_i32(y)
    out = torch.zeros((rows, count + 1, 2, 8), dtype=torch.int64,
                      device=X.device)
    out[:, 1:, 0] = x.reshape(8, rows, count).permute(1, 2, 0)
    out[:, 1:, 1] = y.reshape(8, rows, count).permute(1, 2, 0)
    return u256.to_i32(out)


def table_affine(X, Y, zi, rows: int, ladder: bool):
    """Kernel T2 (``csrc/tables.cu``): same contract as
    ``table_affine_plain``, one launch."""
    if _all_cpu(X, Y, zi):
        return table_affine_plain(X, Y, zi, rows, ladder)
    N, count = _affine_shape(X, rows, ladder)
    dev = _check_cuda("table_affine", [("X", X, (8, N)), ("Y", Y, (8, N)),
                                       ("zi", zi, (8, N))])
    if ladder:
        out = torch.empty((rows, count + 1, 2, 8), dtype=torch.int32,
                          device=dev)
        ptrs = (out.data_ptr(), out.data_ptr())
    else:
        out = tuple(torch.empty((8, count), dtype=torch.int32, device=dev)
                    for _ in range(2))
        ptrs = tuple(t.data_ptr() for t in out)
    with torch.cuda.device(dev):
        _launch("tables", "table_affine", X.data_ptr(), Y.data_ptr(),
                zi.data_ptr(), *ptrs, rows, count, int(ladder), _stream(dev))
    table_affine.launches += 1
    return out


table_affine.launches = 0


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


def p2tr_finish_match(X, Z, zi, ok, dfa_table, dfa_accept, start, remaining,
                      narrow=None, form=None):
    """Kernel I (``csrc/p2tr.cu``): same contract as
    ``p2tr_finish_match_plain``, one launch for all K*B lanes.  The table
    form is ``dfa_form``'s, as kernel D's (``form`` forces one,
    "shared" raising for a table over DFA_SHARED_MAX bytes); the shared
    form reads ``narrow``, the table's ``narrow_dfa`` (the scanner builds
    it once per pattern), or builds it.  ``p2tr_finish_match.launches``
    counts launches, ``p2tr_finish_match.forms`` those of each form."""
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
    table, accept, used = _table_form("p2tr_finish_match", dfa_table,
                                      dfa_accept, narrow, form, dev)
    out = torch.empty((K, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("p2tr", "p2tr_finish_match", int(used == "shared"),
                X.data_ptr(), Z.data_ptr(), zi.data_ptr(), ok.data_ptr(),
                table.data_ptr(), accept.data_ptr(), S, W, int(start),
                remaining.data_ptr(), out.data_ptr(), K, B, _stream(dev))
    p2tr_finish_match.launches += 1
    p2tr_finish_match.forms[used] += 1
    return out


p2tr_finish_match.launches = 0
p2tr_finish_match.forms = dict.fromkeys(DFA_FORMS, 0)


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
    (n_slots, 8); remaining (K,); wt a ladder table; all int32 -> (K, B)
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
                              remaining, wt, narrow=None):
    """Kernels A, F, G, I: bx, by (K, 8); tx, ty (8, B); dfa_table (S, 34),
    dfa_accept (S,) int32; start int; remaining (K,); wt; narrow the
    table's ``narrow_dfa`` or None (kernel I builds it where it takes the
    shared form) -> (K, B) int32 0/1 masks (overflow recovery)."""
    X, Z, zi, ok = _p2tr_ladder_zi(bx, by, tx, ty, wt)
    return p2tr_finish_match(X, Z, zi, ok, dfa_table, dfa_accept, start,
                             remaining, narrow=narrow)


def fused_p2tr_scan_step(bx, by, tx, ty, dfa_table, dfa_accept, start,
                         remaining, wt, narrow=None):
    """One super-step of the P2TR DFA scan -> (K, 34) int32 packed rows."""
    mask = fused_p2tr_scan_mask_step(bx, by, tx, ty, dfa_table, dfa_accept,
                                     start, remaining, wt, narrow)
    return pack_tail(mask, remaining, 1)
