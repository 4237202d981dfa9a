"""A 'windows' axis over a list of torch devices, and the sharded window
step.

Ports `lancet2_tpu/parallel/mesh.py`. Windows are embarrassingly parallel,
so the JAX package shards a window batch on its leading axis over a 1-D
device mesh, runs the whole window step on each shard and aggregates only
scalar run statistics. Here one process drives the list: each entry of the
list gets a shard, and on a CUDA device its own stream, so that the same
card may appear more than once (`[cuda:0] * n`, how a one-card host runs the
multi-device path) and shards still overlap. The JAX version's one
collective, the sum of two scalars over the mesh, is a host-side sum in
device order. No `torch.distributed` is involved.

Stream rules (CUDA entries): `Mesh.on(i)` makes entry i's stream wait for
the device's current stream (inputs made there are ready), then makes it
current. Tensors made inside belong to that stream; `Mesh.gather` joins them
back onto the first entry's current stream. Scratch a kernel wrapper
allocates per launch is allocated inside `on(i)`, so it stays in that
stream's order.
"""

from __future__ import annotations

import contextlib

import torch

from lancet2_tpu_torch.ops.window_step import make_window_step

STEP_KEYS = ("reads", "read_lens", "read_sample", "read_valid", "haps",
             "hap_lens", "hap_allele")


class Mesh:
    """An ordered list of torch devices: the 'windows' axis."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        for d in self.devices:
            if d.type == "cuda" and d.index is None:
                raise ValueError(f"{d}: give CUDA entries an index")
        self.size = len(self.devices)
        self._streams: list | None = None

    def _stream(self, i: int):
        # created at first use: no CUDA call before a caller needs one
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=d)
                             if d.type == "cuda" else None
                             for d in self.devices]
        return self._streams[i]

    @contextlib.contextmanager
    def on(self, i: int):
        """Run the body on entry i: its device, and on CUDA its stream,
        which first waits for the work already queued on the device."""
        dev = self.devices[i]
        if dev.type != "cuda":
            yield dev
            return
        stream = self._stream(i)
        with torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                yield dev

    def keep(self, i: int, *tensors) -> None:
        """Mark tensors made on another stream as used by entry i's
        stream, so their memory is not handed out again before that
        stream's work on them is done."""
        stream = self._stream(i) if self.devices[i].type == "cuda" else None
        if stream is None:
            return
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(stream)

    def gather(self, parts: list) -> torch.Tensor:
        """Concatenate entry i's tensor parts[i] on the first entry's
        device, in device order, once each part's stream is done."""
        dev0 = self.devices[0]
        if dev0.type == "cuda":
            current = torch.cuda.current_stream(dev0)
            for i, part in enumerate(parts):
                if self.devices[i].type == "cuda":
                    current.wait_stream(self._stream(i))
                    part.record_stream(current)
        return torch.cat([p.to(dev0) for p in parts])


def make_mesh(devices) -> Mesh:
    return Mesh(devices)


def split_rows(n: int, size: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of `size` equal shards of n rows (n % size == 0)."""
    if n % size:
        raise ValueError(f"{n} rows do not split into {size} equal shards")
    step = n // size
    return [(i * step, (i + 1) * step) for i in range(size)]


def make_sharded_window_step(mesh: Mesh, num_samples: int, num_alleles: int,
                             band_margin: int | None = None):
    """The window step with the batch axis W split over the mesh.

    Returns (fn, shard_inputs). shard_inputs turns a host batch (a dict of
    arrays or tensors) into the step's argument tuple; fn runs the step of
    each entry on its shard, on the entry's stream, and returns the step's
    dict with every output concatenated on the first entry's device, plus
    `total_alt_depth` (float32, the sum of ALT depth over every shard) and
    `total_windows` (int32), summed in device order. W must be a multiple
    of the mesh size, as the JAX version's sharding requires.
    """
    steps = [make_window_step(num_samples, num_alleles, device=d,
                              band_margin=band_margin)
             for d in mesh.devices]
    keys = list(STEP_KEYS)
    if band_margin is not None:
        keys.append("read_offset")

    def fn(*args):
        W = args[0].shape[0]
        bounds = split_rows(W, mesh.size)
        outs = []
        for i, (lo, hi) in enumerate(bounds):
            with mesh.on(i):
                outs.append(steps[i](*(a[lo:hi] for a in args)))
        out = {k: mesh.gather([o[k] for o in outs]) for k in outs[0]}
        alt = [o["allele_counts"][:, :, 1:].sum().cpu() for o in outs]
        total = alt[0]
        for a in alt[1:]:
            total = total + a
        out["total_alt_depth"] = total
        out["total_windows"] = torch.tensor(W, dtype=torch.int32)
        return out

    def shard_inputs(batch: dict):
        return tuple(torch.as_tensor(batch[k]) for k in keys)

    return fn, shard_inputs
