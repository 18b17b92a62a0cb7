"""Device meshes, sharded tables and the mesh's collectives (port of
``parallel/mesh.py``).

The JAX tier is single-controller: one process drives every shard of a
mesh through ``shard_map``. The port keeps that shape. A :class:`Mesh`
is an ordered tuple of ``torch.device``s along one axis; a pool may
repeat a device, so one card (or the CPU, in the tests) carries any
number of logical shards, as the JAX tests' forced host device count
does. A :class:`Sharded` value holds one part per mesh slot (a
``Table`` or a tensor), each on its slot's device; ``concat`` gives what
``np.asarray`` of a JAX global array gives: the parts in mesh order.

The three collectives the tier uses live here and nowhere else:
:func:`all_to_all` (receiver d takes every sender's block d, in sender
order), :func:`psum` and :func:`all_gather`. Between two CUDA devices
they are device-to-device copies queued on the current stream; on one
device they are views or copies on it. A transport swap is a change to
this module alone.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
from torch.profiler import record_function

from ..column import Column, Table, table_tensors
from ..utils import config, faults, log, metrics

SHUFFLE_AXIS = "shuffle"


class Mesh:
    """A 1-D device mesh: ``devices`` in slot order along ``axis``.
    ``shape[axis]`` is the slot count, as in JAX."""

    def __init__(self, devices: Sequence[torch.device],
                 axis: str = SHUFFLE_AXIS):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = (axis,)
        self.shape = {axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({self.axis_names[0]}={[str(d) for d in self.devices]})"


def device_pool(devices: Optional[Sequence] = None) -> list:
    """The devices a mesh is cut from (the counterpart of
    ``jax.devices()``): ``devices`` as given, else every visible CUDA
    device. Without CUDA the default raises; CPU shards are built only
    when the caller passes them."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=[torch.device('cpu')] * n "
            "to build a mesh of CPU shards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, axis: str = SHUFFLE_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """The 1-D shuffle mesh over the first ``n_devices`` of the pool.

    A mesh shape the pool cannot carry fails loudly, naming the
    requested shape and the remedy. ``mesh`` is an injection site: a
    chaos plan can make construction fail like a dead slice."""
    devs = device_pool(devices)
    n = len(devs) if n_devices is None else int(n_devices)
    if n <= 0:
        raise ValueError(
            f"mesh axis {axis!r}: requested {n} devices; a mesh needs "
            "at least 1")
    if n > len(devs):
        kind = devs[0].type if devs else "none"
        raise ValueError(
            f"mesh axis {axis!r}: requested {n} devices, have "
            f"{len(devs)} ({kind}); shrink the mesh or pass a pool that "
            f"repeats a device, devices=[{devs[0] if devs else 'cpu'}] * "
            f"{n}")
    faults.inject("mesh")
    return Mesh(devs[:n], axis)


def on_device(dev: torch.device):
    """Context for per-shard work on ``dev``: CUDA work (a kernel
    launched through ctypes included) goes to that card."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def per_shard(mesh: Mesh, fn, *args) -> list:
    """``fn(slot, *that slot's part of each of args)`` on each shard's
    device, in mesh order (an arg of None passes None): the per-shard
    phase of a mesh launch."""
    out = []
    for s, dev in enumerate(mesh.devices):
        with on_device(dev):
            out.append(fn(s, *(a[s] if a is not None else None for a in args)))
    return out


# ---------------------------------------------------------------------------
# sharded values
# ---------------------------------------------------------------------------


def map_tensors(value, fn):
    """``fn`` over every tensor of a Table, Column or tensor (None stays
    None), keeping the structure."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, Column):
        return Column(fn(value.data), value.dtype,
                      None if value.validity is None else fn(value.validity),
                      None if value.lengths is None else fn(value.lengths))
    if isinstance(value, Table):
        return Table([map_tensors(c, fn) for c in value.columns],
                     value.names)
    raise TypeError(f"not a Table, Column or tensor: {type(value).__name__}")


def zip_tensors(values: Sequence, fn):
    """``fn`` over the matching tensors of several values of one
    structure (a list of Tables, Columns or tensors); None slots stay
    None."""
    first = values[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(list(values))
    if isinstance(first, Column):
        def slot(get):
            if get(first) is None:
                return None
            return fn([get(v) for v in values])

        return Column(slot(lambda c: c.data), first.dtype,
                      slot(lambda c: c.validity), slot(lambda c: c.lengths))
    if isinstance(first, Table):
        return Table([zip_tensors([v.columns[i] for v in values], fn)
                      for i in range(first.num_columns)], first.names)
    raise TypeError(f"not a Table, Column or tensor: {type(first).__name__}")


class Sharded:
    """One part per mesh slot — a ``Table`` or a tensor each, on the
    slot's device: the port's form of a JAX array sharded over the
    mesh's axis."""

    def __init__(self, parts: Sequence, mesh: Mesh):
        if len(parts) != mesh.size:
            raise ValueError(
                f"{len(parts)} parts for a mesh of {mesh.size} slots")
        self.parts = tuple(parts)
        self.mesh = mesh

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __iter__(self):
        return iter(self.parts)

    @property
    def names(self):
        return self.parts[0].names

    def concat(self, device=None):
        """The parts in mesh order, concatenated on ``device`` (default:
        the mesh's first device)."""
        dev = (self.mesh.devices[0] if device is None
               else torch.device(device))
        return zip_tensors(
            self.parts, lambda ts: torch.cat([t.to(dev) for t in ts]))


def shard_table(table: Table, mesh: Mesh, axis: str = SHUFFLE_AXIS) -> Sharded:
    """Contiguous row blocks of ``table``, one per mesh slot, each on its
    slot's device. The row count must divide by the axis size."""
    n = table.row_count
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(
            f"mesh axis {axis!r} (size {size}): row count {n} is not "
            f"divisible by the shard axis; pad the table to a multiple "
            f"of {size} (the planmesh wrapper does) or build a mesh "
            "whose size divides the row count")
    per = n // size
    return Sharded(
        [map_tensors(table, lambda x, i=i, d=d: x[i * per:(i + 1) * per].to(d))
         for i, d in enumerate(mesh.devices)], mesh)


def replicate_table(table: Table, mesh: Mesh) -> Sharded:
    """A copy of a (small, e.g. dimension) table on every mesh slot."""
    return Sharded([map_tensors(table, lambda x, d=d: x.to(d))
                    for d in mesh.devices], mesh)


def local_shards(table: Sharded) -> int:
    """Number of shards of a sharded value (introspection)."""
    return len(table.parts)


def on_mesh(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Per-shard scalars or rows stacked into one tensor on the mesh's
    first device (the (P,) counts and overflows of the tier)."""
    dev = mesh.devices[0]
    return torch.stack([torch.as_tensor(v).to(dev) for v in values])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _move(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x.to(dev, non_blocking=True)


def all_to_all(blocks: Sequence[Sequence], mesh: Mesh) -> list:
    """``blocks[s][d]`` is sender s's block for receiver d (a Table,
    Column or tensor, the same structure throughout); receiver d gets
    every sender's block d concatenated in sender order, on its
    device."""
    with record_function("mesh.all_to_all"):
        out = []
        for d, dev in enumerate(mesh.devices):
            out.append(zip_tensors(
                [blocks[s][d] for s in range(mesh.size)],
                lambda ts, dev=dev: torch.cat([_move(t, dev) for t in ts])))
        if metrics.enabled():
            # the bytes every receiver took in: shapes only, no sync
            metrics.counter_add("mesh.all_to_all")
            metrics.bytes_add("mesh.exchanged_bytes", sum(
                _nbytes(x) for x in out))
        return out


def _nbytes(value) -> int:
    """Bytes of every tensor of a Table, Column or tensor."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, Column):
        value = Table([value])
    return sum(t.numel() * t.element_size() for t in table_tensors(value))


def psum(values: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """The sum over the mesh of one tensor a slot, on every slot."""
    with record_function("mesh.psum"):
        total = values[0].to(mesh.devices[0])
        for v in values[1:]:
            total = total + _move(v, mesh.devices[0])
        return [_move(total, dev) for dev in mesh.devices]


def all_gather(values: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Every slot's tensor concatenated in mesh order, on every slot."""
    with record_function("mesh.all_gather"):
        return [torch.cat([_move(v, dev) for v in values])
                for dev in mesh.devices]


class MeshHealth:
    """Cheap heartbeat probe of a mesh: one psum with a deadline
    (``SPARK_RAPIDS_TPU_MESH_PROBE_S``).

    A mesh whose collective answers with the right sum within the
    deadline is healthy; a hang past the deadline or any raise (an
    injected ``mesh``-site fault included) marks it unhealthy. The
    heartbeat runs on a worker thread, so a wedged collective costs the
    probe its deadline, never the caller its process."""

    def __init__(self, deadline_s: Optional[float] = None):
        self.deadline_s = (float(config.get_flag("MESH_PROBE_S"))
                           if deadline_s is None else float(deadline_s))

    def probe(self, mesh: Mesh, axis: str = SHUFFLE_AXIS) -> bool:
        """True iff every device of ``mesh`` answered the heartbeat."""
        metrics.counter_add("mesh.probes")
        size = int(mesh.shape[axis])
        verdict = {}

        def beat():
            try:
                faults.inject("mesh")
                out = psum([torch.ones((1,), dtype=torch.int32, device=d)
                            for d in mesh.devices], mesh)
                verdict["ok"] = int(out[0][0]) == size
            except Exception as e:  # any failure is an unhealthy verdict
                verdict["ok"] = False
                verdict["error"] = e
                faults.note_error_class(e, "mesh.probe")

        t = threading.Thread(target=beat, name="srt-mesh-probe", daemon=True)
        t.start()
        t.join(self.deadline_s)
        if t.is_alive():
            # a wedged collective: the deadline is the verdict
            metrics.counter_add("mesh.probe_timeouts")
            log.log("WARN", "faults", "mesh_probe_timeout",
                    devices=size, deadline_s=self.deadline_s)
            return False
        ok = bool(verdict.get("ok"))
        if not ok:
            metrics.counter_add("mesh.probe_failures")
            err = verdict.get("error")
            log.log("WARN", "faults", "mesh_probe_failure", devices=size,
                    error=(f"{type(err).__name__}: {str(err)[:200]}"
                           if err is not None else None))
        return ok
