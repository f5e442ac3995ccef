"""Scans over several devices and processes.

The counterpart of ``vgen_tpu/parallel/mesh.py`` ``MeshScanner``, with its
protocol (``windows_per_super``, ``submit_super_batch``, ``drain_packed``,
``run_super_batch``, ``scan``).  The global device list is process-major:
every process's devices, in rank order (the order of ``jax.devices()``
across hosts).  One super-step covers ``n_devices * k_sub`` windows of B
keys: window j belongs to global device j // k_sub, slot j % k_sub, and
covers keys base + j*B + 1 .. base + (j+1)*B.

Each device runs ``DeviceScanner``'s route for its k_sub windows (the same
intervals, prefilter rule and narrow DFA table; ``fused.fused_*_step``,
kernels A-I on the card), each distinct device holding one copy of the i*G
table and, for P2TR, of the ladder table.  The rows of this process's
devices are stacked on its first device and all-gathered over
torch.distributed (the reference's ``jax.lax.all_gather``), so every
process drains every window; the gathered rows go to pinned host memory
behind a CUDA event.  The drain is ``SuperStepScan``'s.

Unlike the reference, which draws a random scan's start in every process
(``mesh.py:616``, ``:641``) and so maps the other processes' rows to the
wrong keys, rank 0 draws the start and every wrap and broadcasts them.
Rank 0 alone loads and writes a range scan's checkpoint, and broadcasts
the state it resumes from.
"""

from __future__ import annotations

import contextlib
import secrets
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from vgen_tpu_torch.crypto.address import AddressFormat
from vgen_tpu_torch.ops import fused, pipeline
from vgen_tpu_torch.parallel import distributed
from vgen_tpu_torch.pattern import Pattern
from vgen_tpu_torch.scan.host import ScanConfig, ScanResult
from vgen_tpu_torch.scan.scanner import (
    DEFAULT_DEVICE_BATCH,
    DEFAULT_K_SUB,
    DeviceScanner,
    SuperStepScan,
    _copy_to_host,
    _host_rows,
)


def _on(dev: torch.device):
    """The device context of a CUDA device (kernels launch on its current
    stream); nothing for the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class MeshScanner(SuperStepScan):
    """Data-parallel scan over this process's ``devices`` and those of
    every other process of the torch.distributed group.

    ``devices=None`` takes the cards of ``distributed.local_cards()`` and
    raises when there is none; a list may name one device more than once
    (``["cuda:0", "cuda:0"]``, ``["cpu"] * 8``), each entry a device of
    the mesh.  Every process must hold as many devices."""

    def __init__(self, fmt: AddressFormat,
                 batch_size: int = DEFAULT_DEVICE_BATCH, devices=None,
                 k_sub: int = DEFAULT_K_SUB):
        fused.check_format(fmt)
        if devices is None:
            devices = distributed.local_cards()
            if not devices:
                raise RuntimeError("MeshScanner: no CUDA device is visible")
        devices = [torch.device(d) for d in devices]
        if (any(d.type == "cuda" for d in devices)
                and not torch.cuda.is_available()):
            raise RuntimeError("MeshScanner: no CUDA device is visible")
        self.fmt = fmt
        self.batch = batch_size
        self.k_sub = k_sub
        self.devices = devices
        self.rank = distributed.process_index()
        self.world = distributed.world_size()
        # the device collectives run on: this process's first device for
        # NCCL, the host for gloo; None outside a process group
        self._coll = None
        if distributed.is_initialized():
            self._coll = (devices[0] if dist.get_backend() == "nccl"
                          else torch.device("cpu"))
            if self._coll.type != "cuda" and dist.get_backend() == "nccl":
                raise ValueError("MeshScanner: an NCCL group needs CUDA "
                                 f"devices, got {devices[0]}")
        counts = self._gather(torch.tensor([len(devices)]))
        if len(set(counts.tolist())) != 1:
            raise ValueError("MeshScanner: the processes hold different "
                             f"numbers of devices: {counts.tolist()}")
        self.n_devices = self.world * len(devices)
        self.windows = self.n_devices * k_sub
        # one DeviceScanner (its tables and route) per distinct device: each
        # card builds its own tables, in milliseconds, where the JAX package
        # builds on its first device and replicates
        # (vgen_tpu/parallel/mesh.py:281-283)
        self._scanners = {}
        for dev in devices:
            if dev not in self._scanners:
                with _on(dev):
                    self._scanners[dev] = DeviceScanner(fmt, batch_size, dev,
                                                        k_sub)

    # -- collectives -------------------------------------------------------

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """This process's rows followed by every other process's, in rank
        order (all_gather); outside a process group, ``local``."""
        if self._coll is None:
            return local
        local = local.to(self._coll)
        out = local.new_empty((self.world * local.shape[0],
                               *local.shape[1:]))
        # one collective into one tensor (torch 2.13 renamed
        # all_gather_into_tensor all_gather_single)
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        gather(out, local)
        return out

    def _broadcast(self, obj):
        """Rank 0's ``obj`` in every process."""
        if self._coll is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, device=self._coll)
        return box[0]

    # -- SuperStepScan -----------------------------------------------------

    def _plan(self, pattern: Pattern, config: ScanConfig, glv: bool):
        routes = {}
        for dev, scanner in self._scanners.items():
            with _on(dev):
                step, mask_step, exact = scanner._route(pattern, config, glv)
            routes[dev] = (step, mask_step)
        return routes, exact

    def _submit(self, routes, base_scalars: List[int],
                rems: Optional[List[int]]):
        K = self.k_sub
        first = self.rank * len(self.devices) * K  # this process's windows
        rows = []
        for d, dev in enumerate(self.devices):
            scanner = self._scanners[dev]
            win = slice(first + d * K, first + (d + 1) * K)
            with _on(dev):
                remaining = (scanner._full_remaining if rems is None
                             else scanner._remaining(rems[win]))
                bx, by = scanner._base_points(base_scalars[win])
                rows.append(routes[dev][0](bx, by, remaining))
        dev0 = self.devices[0]
        with _on(dev0):
            # the event is recorded after the gather, so the copy to the
            # host waits for the gathered rows
            local = torch.cat([r.to(dev0) for r in rows])
            return _copy_to_host(self._gather(local))

    def _window_indices(self, routes, base_scalar: int, rem: int):
        """Overflow recovery: the window again, through the mask step on
        this process's first device."""
        dev0 = self.devices[0]
        with _on(dev0):
            return self._scanners[dev0]._window_indices(
                routes[dev0], base_scalar, rem)

    def _random_start(self, n: int) -> int:
        return self._broadcast(2 + secrets.randbelow(n) if self.rank == 0
                               else None)

    def _checkpoint(self, ckpt):
        state = ckpt.load() if ckpt is not None and self.rank == 0 else None
        return (ckpt if self.rank == 0 else None), self._broadcast(state)

    def _synchronize(self) -> None:
        for dev in self._scanners:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- the reference's protocol -----------------------------------------

    def windows_per_super(self, pattern: Pattern,
                          allow_glv: bool = False) -> int:
        """Key windows (of ``batch`` keys) covered by one super-batch."""
        return self.windows

    def submit_super_batch(self, pattern: Pattern, base_scalar: int,
                           remaining_total: Optional[int] = None,
                           allow_glv: bool = False):
        """Launch one super-batch over the mesh without waiting for it; pass
        the handle to ``drain_packed``.  Window j covers keys
        [base_scalar + j*B + 1, base_scalar + (j+1)*B], at most
        ``remaining_total - j*B`` of them.  ``allow_glv`` (random scans):
        the GLV formats check six keys per position."""
        glv = allow_glv and self.fmt in pipeline.GLV_FORMATS
        # _route reads only whether the config is a range scan
        config = ScanConfig(format=self.fmt, start=None if allow_glv else 1)
        routes = self._plan(pattern, config, glv)[0]
        B, W = self.batch, self.windows
        rems = (None if remaining_total is None else
                [max(0, min(B, remaining_total - j * B)) for j in range(W)])
        return self._submit(routes, [base_scalar + j * B for j in range(W)],
                            rems)

    def drain_packed(self, handle) -> np.ndarray:
        """Wait for a ``submit_super_batch`` handle -> (W, 34) int32 rows
        [count, ops, idx0..15, vbits0..15], one per window."""
        return _host_rows(handle)

    def run_super_batch(self, pattern: Pattern, base_scalar: int,
                        remaining_total: Optional[int] = None,
                        allow_glv: bool = False):
        """``submit_super_batch`` and wait -> (counts, indices, ops,
        total_count, total_ops), one row per window."""
        arr = self.drain_packed(self.submit_super_batch(
            pattern, base_scalar, remaining_total, allow_glv))
        return (arr[:, 0], arr[:, 2:2 + pipeline.TOP_K], arr[:, 1],
                int(arr[:, 0].sum()), int(arr[:, 1].sum()))

    def scan(self, pattern: Pattern, count: int = 1,
             start: Optional[int] = None, end: Optional[int] = None,
             progress_callback=None, stop_flag=None,
             max_super_batches: Optional[int] = None, checkpoint=None,
             in_flight: int = 2) -> ScanResult:
        """A random scan (``start`` None) or the range [start, end], with
        up to ``in_flight`` super-batches in flight and at most
        ``max_super_batches`` of them."""
        config = ScanConfig(format=self.fmt, count=count, start=start,
                            end=end, in_flight=in_flight,
                            checkpoint=checkpoint)
        return self._scan(pattern, config, progress_callback, stop_flag,
                          recover_overflow=True,
                          max_super_steps=max_super_batches)
