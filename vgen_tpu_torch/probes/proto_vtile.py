"""Kernel B's block geometry on the card: kernel ``probe_vtile`` and its
tool.

    python -m vgen_tpu_torch.probes.proto_vtile

The counterpart of ``scripts/proto_vtile.py`` (its
``make_vtile_range_glv(fmt, B, V, T)`` :40, ``pallas_call`` :65), which
ran kernel B's P2PKH body on (V, T) tiles of lanes against flat rows, to
give each dependent step of the TPU's vector unit more lanes.  On the card
a lane is a thread, and the question becomes the block: ``probe_vtile``
runs kernel B's P2PKH lane (``range_glv_lane`` itself) over blocks of T
threads (a launch argument, 64 to 512), each thread taking V keys (a
template, 1, 2 or 4) one after another, keys e = (block V + j) T + t as
in the TPU's tile.  Geometry changes no value: every (V, T) returns
production kernel B's mask (256 threads, one key each), and its plain
version is kernel B's (``fused.range_glv_match_plain``).

The inputs are the script's (``np.random.RandomState(7)``): random 16-bit
limbs for tx, ty, inv, bx and by, and the script's eight interval slots
(slot 0 from 0 to (2^24, 2^32 - 1, ...), slots 1-7 empty).  At B =
524288 the tool prints ms per window and keys/s for each (V, T) beside
production B, each mask checked equal to B's, and the ptxas figures of
each V.  It measures the card only: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.ops import fused, u256
from vgen_tpu_torch.probes import bound_model as bm
from vgen_tpu_torch.probes import common, profile_glv, timing

P2PKH = AddressFormat.P2PKH
KEYS_PER_THREAD = (1, 2, 4)  # V, the kernel's template
THREADS = (64, 128, 256, 512)  # T, its block


def instances():
    return [(v, t) for v in KEYS_PER_THREAD for t in THREADS]


def instance_name(v: int, t: int) -> str:
    return f"{v}x{t}"


def vtile_inputs(B: int, seed: int = 7):
    """The script's inputs for one window of B lanes (``proto_vtile.py``
    :110-123): (bx, by, tx, ty, inv, lo, hi, remaining), CPU int32."""
    rng = np.random.RandomState(seed)

    def limbs(shape):
        return u256.limbs16_to_32(
            rng.randint(0, 1 << 16, size=shape).astype(np.uint32))

    tx, ty, inv = (u256.as_i32(limbs((16, B))) for _ in range(3))
    bx, by = (u256.as_i32(limbs((16, 1)).T) for _ in range(2))
    lo = np.zeros((8, 5), dtype=np.uint32)
    hi = np.zeros((8, 5), dtype=np.uint32)
    lo[:, 4] = 1
    lo[0] = [0, 0, 0, 0, 0]
    hi[0] = [1 << 24, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF]
    remaining = torch.tensor([B], dtype=torch.int32)
    return bx, by, tx, ty, inv, u256.as_i32(lo), u256.as_i32(hi), remaining


def probe_vtile_plain(bx, by, tx, ty, inv, lo, hi, remaining):
    """Plain version of ``probe_vtile``, for every (V, T): kernel B's
    P2PKH mask, (K, B) int32."""
    return fused.range_glv_match_plain(P2PKH, bx, by, tx, ty, inv, lo, hi,
                                       remaining)


def probe_vtile(keys_per_thread, threads, bx, by, tx, ty, inv, lo, hi,
                remaining):
    """Kernel ``probe_vtile`` (``probes/probes.cu``) with V =
    ``keys_per_thread`` and blocks of T = ``threads``, one launch; kernel
    B's arguments and result.  The plain version for CPU tensors."""
    if keys_per_thread not in KEYS_PER_THREAD or threads not in THREADS:
        raise ValueError(f"unknown instance V={keys_per_thread} T={threads}")
    args = (bx, by, tx, ty, inv, lo, hi, remaining)
    if all(t.device.type == "cpu" for t in args):
        return probe_vtile_plain(*args)
    out = common.launch_interval("probe_vtile", (keys_per_thread, threads),
                                 args)
    probe_vtile.launches += 1
    return out


probe_vtile.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vgen_tpu_torch.probes.proto_vtile",
        description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    card = timing.Card()
    from vgen_tpu_torch.csrc import build

    B, tag = common.TIMED_N, card.tag()
    args = tuple(t.to(card.device) for t in vtile_inputs(B))
    n_slots = args[5].shape[0]
    probe_vtile(1, 256, *args)  # builds the probe library
    ptxas = timing.ptxas_figures(build.build_log(("probes",)), "probe_vtile")
    ref = fused.range_glv_match(P2PKH, *args)
    ms_b = timing.launch_ms(lambda: fused.range_glv_match(P2PKH, *args))
    bms, bby = bm.bound(B * profile_glv.stage_count("full", n_slots),
                        profile_glv.stage_nbytes(1, B, n_slots),
                        card.sm_clocks_per_s)
    print(f"# proto_vtile: kernel B's P2PKH lane over blocks of T threads, V "
          f"keys per thread, one window of B={B} (the script's random inputs, "
          f"{int((ref != 0).sum())} matching lanes); ms per launch, best of "
          f"five means of 10; bound {bms:.4f} ms ({bby}) {tag}", flush=True)
    print(f"production B (256 threads, V=1): {ms_b:.4f} ms, "
          f"{6 * B / ms_b / 1e3:.1f} M keys/s {tag}", flush=True)
    for v, t in instances():
        out = probe_vtile(v, t, *args)
        if not torch.equal(out, ref):
            print(f"error: V={v} T={t} differs from kernel B", file=sys.stderr)
            return 1
        ms = timing.launch_ms(lambda: probe_vtile(v, t, *args))
        print(f"V={v} T={t}: {ms:.4f} ms, {6 * B / ms / 1e3:.1f} M keys/s, "
              f"{ms / ms_b:.3f} of B's time, mask == B's; ptxas (V={v}) "
              f"{timing.ptxas_text(ptxas.get((v,)))} "
              f"{tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
