"""The port's MeshScanner scans on a mesh of CPU devices: the cases of the
reference's tests/test_mesh.py, on the port alone.  The mesh is two CPU
devices of four windows each, the reference's eight windows of a
super-batch; the scans run the kernels' plain versions."""

import collections
import re

import pytest
import torch

from test_torch_support import one_torch_thread  # noqa: F401 (autouse)
from vgen_tpu_torch import tracing
from vgen_tpu_torch.crypto.address import AddressFormat, AddressGenerator
from vgen_tpu_torch.ops import pipeline
from vgen_tpu_torch.parallel.mesh import MeshScanner
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan import scanner as sc
from vgen_tpu_torch.scan.checkpoint import CheckpointManager
from vgen_tpu_torch.scan.host import ScanConfig, StopFlag

BATCH = 256
P2PKH = AddressFormat.P2PKH
W = 8  # windows of a super-batch


@pytest.fixture(scope="module")
def mesh():
    scanner = MeshScanner(P2PKH, BATCH, ["cpu"] * 2, k_sub=4)
    assert scanner.n_devices == 2 and scanner.windows == W
    return scanner


def _exact(key, fmt=P2PKH):
    addr = AddressGenerator(fmt).generate(key.to_bytes(32, "big")).address
    return Pattern(f"^{re.escape(addr)}$")


def _hex(key):
    return key.to_bytes(32, "big").hex()


def test_super_batch_window_key_mapping(mesh):
    """A key's match lands in its window (device 1, slot 1) at its index."""
    base, win, idx = 50_000, 5, 37
    key = base + win * BATCH + 1 + idx
    counts, indices, ops, total_count, total_ops = mesh.run_super_batch(
        _exact(key), base_scalar=base)
    assert counts.tolist() == [int(j == win) for j in range(W)]
    assert int(indices[win][0]) == idx
    assert total_count == 1 and total_ops == W * BATCH
    assert mesh.windows_per_super(_exact(key)) == W


def test_mesh_range_remaining_mask(mesh):
    """A range shorter than one super-batch: ops equal the range's size."""
    n_keys = 3 * BATCH + 17
    res = mesh.scan(Pattern("^1ZZZZZZZZZZZ"), count=1, start=9000,
                    end=9000 + n_keys - 1)
    assert res.matches == [] and res.operations == n_keys


def test_mesh_scan_range_finds_key(mesh):
    key = 0x54321
    res = mesh.scan(_exact(key), count=1, start=0x54000, end=0x55000)
    assert [m.hex for m in res.matches] == [_hex(key)]


def test_mesh_scan_random_mode(mesh):
    res = mesh.scan(Pattern("^1"), count=3)
    assert len(res.matches) == 3 and res.operations >= 3


def _manager(path, pat, start, end):
    return CheckpointManager(str(path), pattern=pat, fmt="p2pkh",
                             start=start, end=end, save_interval_secs=0.0)


def test_mesh_scan_checkpoint_resume(mesh, tmp_path):
    """Stop after two super-batches (max_super_batches), resume from the
    checkpoint: the union equals an uninterrupted run."""
    pat = Pattern("^1B")
    start, end = 0x100, 0x100 + 5 * W * BATCH - 1
    full = mesh.scan(pat, count=0, start=start, end=end)
    expected = sorted(m.address for m in full.matches)
    assert expected
    path = tmp_path / "mesh.json"
    partial = mesh.scan(pat, count=0, start=start, end=end,
                        checkpoint=_manager(path, "^1B", start, end),
                        max_super_batches=2)
    assert partial.operations == 2 * W * BATCH
    resumed = mesh.scan(pat, count=0, start=start, end=end,
                        checkpoint=_manager(path, "^1B", start, end))
    assert resumed.operations == full.operations == end - start + 1
    assert sorted(m.address for m in resumed.matches) == expected


def test_mesh_resume_after_mid_scan_stop(mesh, tmp_path):
    """A stop that lands with a super-batch in flight, then a resume: every
    key of the range once, in order (three super-batches: the stop's
    drain takes two)."""
    start, end = 6000, 6000 + 3 * W * BATCH - 1
    path = tmp_path / "mesh_stop.json"
    flag = StopFlag()
    fired = []

    def cb(ops):
        if not fired:
            fired.append(ops)
            flag.set()

    partial = mesh.scan(Pattern("^1"), count=0, start=start, end=end,
                        checkpoint=_manager(path, "^1", start, end),
                        in_flight=2, stop_flag=flag, progress_callback=cb)
    assert fired and partial.operations < end - start + 1
    resumed = mesh.scan(Pattern("^1"), count=0, start=start, end=end,
                        checkpoint=_manager(path, "^1", start, end),
                        in_flight=2)
    assert [int(m.hex, 16) for m in resumed.matches] == list(
        range(start, end + 1))
    assert resumed.operations == end - start + 1


def test_mesh_range_reports_all_matches_beyond_topk(mesh):
    """Windows with more matches than TOP_K slots are recovered in full."""
    start, n_keys = 7000, W * BATCH + 100
    res = mesh.scan(Pattern("^1"), count=0, start=start,
                    end=start + n_keys - 1)
    assert res.operations == n_keys
    assert sorted(int(m.hex, 16) for m in res.matches) == list(
        range(start, start + n_keys))


def test_mesh_overflow_deep_pipeline_doubling_slot(mesh):
    """in_flight=3, every key matching, and a base below the batch (window
    0 holds the doubling lane, key 98, which the host checks): every key
    once, in order."""
    start, n_keys = 50, 2 * W * BATCH + 100
    res = mesh.scan(Pattern("^1"), count=0, start=start,
                    end=start + n_keys - 1, in_flight=3)
    assert [int(m.hex, 16) for m in res.matches] == list(
        range(start, start + n_keys))
    assert res.operations == n_keys


def test_mesh_random_overflow_recovery_reaches_count(mesh):
    """A random scan asking for more matches than the TOP_K slots hold:
    overflow recovery delivers them, none twice."""
    want = 2 * W * pipeline.TOP_K
    res = mesh.scan(Pattern("^1"), count=want)
    assert len(res.matches) == want
    assert len({m.hex for m in res.matches}) == want


def test_mesh_scan_pipelined_matches_unpipelined(mesh):
    key = 0x54321
    for n in (1, 3):
        res = mesh.scan(_exact(key), count=0, start=0x54000,
                        end=0x54000 + 4 * W * BATCH - 1, in_flight=n)
        assert [m.hex for m in res.matches] == [_hex(key)]
        assert res.operations == 4 * W * BATCH


def test_mesh_replays_each_devices_route(monkeypatch):
    """Each device's windows of a super-step run through its scanner's
    route, as on one card: every call after the route's first replays its
    graph (on the CPU, runs its step again) and counts ``graph_replays``.
    The two devices share one scanner, so the first super-step's second
    device replays already.  The counters are read through
    ``tracing.count`` with no profiler: a profiler counts the same calls,
    and its stop takes tens of seconds over the plain versions' many small
    ops."""
    counters = collections.Counter()
    monkeypatch.setattr(tracing, "count",
                        lambda name, n=1: counters.update({name: n}))
    mesh = MeshScanner(P2PKH, BATCH, ["cpu"] * 2, k_sub=1)
    steps, windows = 3, mesh.windows
    res = mesh.scan(Pattern("^1Qq"), count=0, start=0x9000,
                    end=0x9000 + steps * windows * BATCH - 1)
    assert res.operations == steps * windows * BATCH
    assert counters["super_steps"] == steps
    assert counters["graph_replays"] == mesh.n_devices * steps - 1


@pytest.mark.parametrize("mesh_opt,scanner_type", [
    (True, MeshScanner), (False, sc.DeviceScanner), (None, sc.DeviceScanner)])
def test_scan_with_progress_mesh_routing(monkeypatch, mesh_opt, scanner_type):
    """ScanConfig.mesh: True takes the mesh, False the DeviceScanner, None
    (auto) the DeviceScanner off the card."""
    monkeypatch.setattr(sc, "_scanner_cache", {})
    key = 0x2BEEF
    res = sc.scan_with_progress(_exact(key), ScanConfig(
        format=P2PKH, device_batch_size=BATCH, start=0x2B000, end=0x2C000,
        count=0, mesh=mesh_opt), device="cpu")
    assert [m.hex for m in res.matches] == [_hex(key)]
    assert res.operations == 0x1001
    (scanner,) = sc._scanner_cache.values()
    assert type(scanner) is scanner_type


@pytest.mark.parametrize("count,world,want", [
    (1, 1, False), (2, 1, True), (1, 2, True)])
def test_auto_mesh_on_the_card(monkeypatch, count, world, want):
    """Auto takes the mesh on the card when this process sees several
    cards or the process group spans several processes; never off it."""
    from vgen_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    cfg = ScanConfig(format=P2PKH)
    assert sc._use_mesh(cfg, "cuda") is want
    assert sc._use_mesh(cfg, "cpu") is False
    assert sc._use_mesh(ScanConfig(mesh=False), "cuda") is False


def test_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshScanner(P2PKH, BATCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshScanner(P2PKH, BATCH, ["cuda:0", "cuda:0"])
