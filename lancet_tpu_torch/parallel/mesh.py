"""A mesh of devices in one process, and the batched steps sharded over it.

The reference's parallelism is share-nothing windows over pthreads with a
serial merge (Lancet.cc:844-959). The JAX package maps it to a 1-D
`jax.sharding.Mesh` and `shard_map`: one program per device on its slice
of the window (or pair) axis, each device's fixpoint loops exiting on its
own shard, outputs left sharded, three counters reduced by one psum.

Here a `Mesh` is an ordered tuple of `torch.device`s; an entry may repeat
(four entries of cuda:0 are four shards on one card, and `["cpu"] * 8`
eight shards on the host). A sharded call splits every host array input
on its leading window axis into len(mesh) equal contiguous shards, moves
each shard to its device (inputs already there come as a `Sharded` list
of per-shard values), and runs the step for each shard in a host thread
of its own, inside `torch.cuda.device(d)` and on the mesh entry's own
CUDA stream, so a shard's loops exit on its own predicate, as under
shard_map; each shard call ends with its stream synchronized, so its
outputs can be read from any thread and stream. A one-entry mesh is the
unsharded run: its step runs inline, on the calling thread and the
device's current stream, and is not synchronized. The outputs stay on
their shards' devices, as a list in shard order: `gather` fetches a field
to the host and concatenates it on the window axis. The counters are
summed on the host after the join. No tensor moves from one device to
another.

Not carried over: `mesh_key` and the executable caches (the port compiles
nothing per shape), and the JAX mesh DP's padding of the pair axis to a
power of two (`mesh.py:190-198`), which exists only for static shapes.
"""

from __future__ import annotations

import concurrent.futures as _cf
import contextlib
import threading

import numpy as np
import torch

from ..gpu import resolve_device


class Mesh(tuple):
    """An ordered tuple of torch.devices, each the device of one shard.
    In a mesh of several entries each CUDA entry gets a stream of its own
    (made at first use), which every sharded call of that entry runs on."""

    def __new__(cls, devices):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self = super().__new__(cls, devs)
        self._streams = None
        self._lock = threading.Lock()
        return self

    def streams(self) -> list:
        """One CUDA stream per entry (None for a CPU entry)."""
        with self._lock:
            if self._streams is None:
                self._streams = [torch.cuda.Stream(device=d)
                                 if d.type == "cuda" else None for d in self]
            return self._streams

    @contextlib.contextmanager
    def on_shard(self, i: int):
        """Context: entry i's device current, and its own stream too when
        the mesh has several entries (nothing for a CPU entry)."""
        d = self[i]
        if d.type != "cuda":
            yield
        elif len(self) == 1:
            with torch.cuda.device(d):
                yield
        else:
            with torch.cuda.device(d), torch.cuda.stream(self.streams()[i]):
                yield


def make_mesh(n: int | None = None, devices=None) -> Mesh:
    """A mesh over the first `n` cards (all visible cards when n is None),
    or over the explicit `devices` (repeats allowed, e.g. ["cpu"] * 8 or
    ["cuda:0"] * 4). Raises without a card, and when n exceeds the cards
    present (it does not quietly take fewer)."""
    if devices is not None:
        if n is not None and n != len(devices):
            raise ValueError(f"n={n} but {len(devices)} devices given")
        return Mesh(devices)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device is available (pass "
                           "devices=['cpu'] * n for a mesh on the host)")
    if n is None:
        n = count
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} devices asked for, {count} "
                         "present")
    return Mesh([f"cuda:{i}" for i in range(n)])


# this process's cards are the ones it sees (a launcher gives each process
# its own through CUDA_VISIBLE_DEVICES); the JAX package's name
make_local_mesh = make_mesh


def _rows(a, lo: int, hi: int, dev):
    """The rows [lo, hi) of the host array `a`, as a tensor on `dev`."""
    return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev)


class Sharded(list):
    """Per-shard values in mesh order, each on its shard's device: passed
    to a sharded call, shard i's value goes to shard i as it is."""


def _shard_width(mesh: Mesh, args) -> int:
    """Windows a shard: every argument that is not Sharded is a host array
    with the window axis first, cut into len(mesh) equal contiguous
    shards. Raises when the axes differ or do not split evenly."""
    n = len(mesh)
    widths = set()
    for a in args:
        if isinstance(a, Sharded):
            if len(a) != n:
                raise ValueError(f"{len(a)} shards given for a mesh of {n}")
        elif isinstance(a, np.ndarray):
            widths.add(a.shape[0])
        else:
            raise TypeError("a sharded call cuts host arrays; pass tensors "
                            "already on the shards' devices as a Sharded "
                            "list")
    if len(widths) > 1:
        raise ValueError(f"window axes differ: {sorted(widths)}")
    W = widths.pop() if widths else 0
    if W % n:
        raise ValueError(f"{W} windows do not split into {n} equal shards")
    return W // n


def _map(mesh: Mesh, fn, args) -> list:
    """fn(*shard i's arguments) for every shard i, each in its own thread
    with its device and stream current, each returning after its stream
    has finished (a one-entry mesh: inline and unsynchronized); results in
    shard order. Shard i's arguments are built on its device inside its
    thread: a Sharded argument gives its entry i, any other its rows of
    shard i."""
    w = _shard_width(mesh, args)

    def one(i):
        with mesh.on_shard(i):
            out = fn(*[a[i] if isinstance(a, Sharded)
                       else _rows(a, i * w, (i + 1) * w, mesh[i])
                       for a in args])
            if mesh[i].type == "cuda" and len(mesh) > 1:
                torch.cuda.current_stream(mesh[i]).synchronize()
        return out

    if len(mesh) == 1:
        return [one(0)]
    with _cf.ThreadPoolExecutor(max_workers=len(mesh)) as ex:
        return list(ex.map(one, range(len(mesh))))


def shard_windows(impl, mesh: Mesh):
    """`impl` (a batched step whose inputs and outputs have the window batch
    as their leading axis, its outputs a dict holding numcomp, n_sel and
    fallback) sharded on the window axis over `mesh`: the counterpart of
    the JAX package's shard_windows_jit. Returns a function of impl's
    arguments that returns (the per-shard output dicts, a Sharded list on
    the shards' devices; mesh_counters, int32 [3] on the host: numcomp,
    n_sel and fallback summed over every window of every shard)."""

    def local(*args):
        out = impl(*args)
        counters = torch.stack([out[k].to(torch.int64).sum() for k in
                                ("numcomp", "n_sel", "fallback")]).cpu()
        return out, counters

    def run(*args):
        res = _map(mesh, local, args)
        counters = torch.stack([c for _, c in res]).sum(0)
        return Sharded(o for o, _ in res), counters.to(torch.int32)

    return run


def shard_build_k(mesh: Mesh, K: int, statics: tuple):
    """gpu.dbg.build_k for one k, sharded on the window axis over `mesh`:
    each shard builds its windows' graphs; no collective (the build is
    independent per window). `statics` is (N, E, D, Lraw, min_qual_call,
    low_cov_threshold, min_cov_ratio). Returns a function of build_k's
    array arguments (host numpy arrays) that returns the per-shard build
    dicts as a Sharded list."""
    from ..gpu.dbg import build_k

    N, E, D, Lraw, min_qual_call, low_cov_threshold, min_cov_ratio = statics

    def local(*arrs):
        return build_k(K, *arrs, N=N, E=E, D=D, Lraw=Lraw,
                       min_qual_call=min_qual_call,
                       low_cov_threshold=low_cov_threshold,
                       min_cov_ratio=min_cov_ratio)

    return lambda *arrs: Sharded(_map(mesh, local, arrs))


def gather(parts) -> np.ndarray:
    """Fetch per-shard tensors to the host and concatenate them on the
    window axis, in shard order."""
    return np.concatenate([p.cpu().numpy() for p in parts])


def mesh_batch_align_async(pairs: list, mesh: Mesh):
    """The batched Gotoh alignment split on the pair axis over `mesh`: the
    pairs are cut into len(mesh) contiguous slices (sizes differing by at
    most one), and each non-empty slice is one gotoh_align launch on its
    entry's device and stream (gpu.align_batch.batch_align_async). Returns
    the list of per-slice states, which gpu.align_batch.batch_align_wait
    decodes in pair order after each slice's event (None for no pairs).
    The alignments do not depend on the split. Unlike the JAX function,
    the pair axis is not padded: the port needs no static shapes."""
    from ..gpu.align_batch import batch_align_async

    if not pairs:
        return None
    q, r = divmod(len(pairs), len(mesh))
    states = []
    lo = 0
    for i, d in enumerate(mesh):
        hi = lo + q + (i < r)
        if hi > lo:
            with mesh.on_shard(i):
                states.append(batch_align_async(pairs[lo:hi], d))
        lo = hi
    return states
