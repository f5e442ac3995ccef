"""The port's multi-process scan over torch.distributed (gloo, on the CPU).

``initialize`` in this process: a no-op without a cluster's variables, an
error on an unreachable coordinator.  Then two processes (this file run
as a script: it imports only torch and the port), each a mesh of two CPU
devices, join through a ``file://`` init method and run the reference
worker's range scan (``scripts/distributed_worker.py``: a planted key in
0x1000 keys) and a random scan of ^1 with count 3."""

import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import torch

from vgen_tpu_torch.parallel import distributed

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = 0x54321
START, END = 0x54000, 0x54FFF  # 4096 keys: one super-batch of 4 x 4 x 256
CHILD_TIMEOUT_S = 120


def test_initialize_is_a_noop_without_a_cluster(monkeypatch):
    for k in ("VGEN_COORDINATOR", "VGEN_NUM_PROCESSES", "VGEN_PROCESS_ID",
              "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.is_initialized() is False
    assert distributed.is_multi_host() is False
    assert (distributed.process_index(), distributed.world_size()) == (0, 1)


def test_initialize_raises_on_an_unreachable_coordinator(monkeypatch):
    """Rank 1 of two, at a local port where nothing listens: the group
    cannot form within the (shortened) timeout, and initialize raises (the
    reference warns and scans alone)."""
    import pytest

    monkeypatch.setattr(distributed, "TIMEOUT_S", 1.0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError):
        distributed.initialize(f"127.0.0.1:{port}", 2, 1, device="cpu")
    assert distributed.is_initialized() is False


def _worker(out_path: str, ckpt_path: str) -> None:
    """One process of the pair: VGEN_* variables, gloo, devices ["cpu"] * 2."""
    torch.set_num_threads(1)
    from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
    from vgen_tpu_torch.parallel.mesh import MeshScanner
    from vgen_tpu_torch.pattern import Pattern
    from vgen_tpu_torch.scan.checkpoint import CheckpointManager

    assert distributed.initialize(device="cpu") is True
    fmt = AddressFormat.P2PKH
    addr = AddressGenerator(fmt).generate(KEY.to_bytes(32, "big")).address
    pat = Pattern(f"^{re.escape(addr)}$")
    ckpt = CheckpointManager(ckpt_path, pattern=pat.original, fmt=fmt.value,
                             start=START, end=END, save_interval_secs=0.0)
    sc = MeshScanner(fmt, 256, ["cpu"] * 2, k_sub=4)
    res = sc.scan(pat, count=0, start=START, end=END, checkpoint=ckpt)
    rand = sc.scan(Pattern("^1"), count=3)
    gen = AddressGenerator(fmt)
    result = {
        "rank": distributed.process_index(),
        "world": distributed.world_size(),
        "n_mesh_devices": sc.n_devices,
        "matches": sorted(m.hex for m in res.matches),
        "operations": res.operations,
        "ckpt_exists": os.path.exists(ckpt_path),
        "random": [m.hex for m in rand.matches],
        "random_confirmed": all(
            gen.generate(bytes.fromhex(m.hex)).address == m.address
            and m.address.startswith("1") for m in rand.matches),
    }
    torch.distributed.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(result, f)


def test_two_process_mesh_scans(tmp_path):
    """Each process sees world 2 and 4 mesh devices; both report the
    planted key and the whole range's operations; only rank 0 writes its
    checkpoint.  The random scan: both ranks report the same three keys,
    drawn from rank 0's start."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), GLOO_SOCKET_IFNAME="lo",
               VGEN_COORDINATOR=f"file://{tmp_path / 'store'}",
               VGEN_NUM_PROCESSES="2")
    procs = []
    for rank in range(2):
        out, ckpt = tmp_path / f"out{rank}.json", tmp_path / f"ckpt{rank}.json"
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(out), str(ckpt)],
            env=dict(env, VGEN_PROCESS_ID=str(rank)), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out))
    results = []
    try:
        for p, out in procs:
            stdout, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, stdout.decode()[-4000:]
            results.append(json.loads(out.read_text()))
    finally:
        for p, _ in procs:
            p.kill()
            p.wait()
    r0, r1 = sorted(results, key=lambda r: r["rank"])
    for r in (r0, r1):
        assert (r["world"], r["n_mesh_devices"]) == (2, 4)
        assert r["matches"] == [KEY.to_bytes(32, "big").hex()]
        assert r["operations"] == END - START + 1
        assert len(r["random"]) == 3 and r["random_confirmed"]
    assert r0["ckpt_exists"] is True and r1["ckpt_exists"] is False
    assert r0["random"] == r1["random"]


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
