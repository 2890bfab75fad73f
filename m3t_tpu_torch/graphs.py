"""CUDA graphs for the fused cycles and the host path: the port's counterpart of the JAX
package's ``jax.jit``.

The JAX package jit-compiles its fused cycles (``m3t_tpu/pipeline.py``: ``tracking_cycle``,
``tracking_cycle_rgbd`` and ``tracking_cycle_kinematic``, each with
``static_argnames=("pcfg",)``, and the multi-camera cycles) and six functions of the
host path: the region modality's ``_correspondences_jit``, ``_gradient_hessian_jit`` and
``_add_colors_jit``, the depth modality's ``_correspondences_jit`` and
``_gradient_hessian_jit``, and ``ops/raster.py``'s ``rasterize``.  Each is one compiled
program per static key, traced once and then run without the host.  :func:`graphed` does
the same for a function of tensors on the card.  The first call for a key runs the
function eagerly (the warm-up, which plays the part of tracing) and returns that result;
it then captures the function into a ``torch.cuda.CUDAGraph``.  Every later call with
that key copies its tensors into the graph's static buffers, replays the graph and
returns fresh outputs.  On CPU tensors the function runs eagerly, exactly as without the
decorator: the port's CPU path, as interpret mode is the JAX package's for its Pallas
kernels.

The names mirror JAX's: ``graphed(static_argnames=...)`` for
``functools.partial(jax.jit, static_argnames=...)``, :func:`disable_graphs` for
``jax.disable_jit()`` (the only way to run a decorated function eagerly on the card) and
:func:`clear_graphs` for ``jax.clear_caches()``.

The static key of a call is made of:
  * the static arguments, by value (they must be hashable, as JAX asks);
  * every Python or numpy scalar, bool and None among the other arguments, by type and
    value, and every numpy array by its shape, dtype and bytes;
  * the structure of tuples, lists and NamedTuples;
  * for each tensor, its shape, dtype, device and which of its dimensions are expanded
    (size > 1 and stride 0).
One difference from JAX: JAX traces the camera values (``intr``, ``depth_intr``,
``depth_scale`` of the cycles, the intrinsics of the host path's functions), while the
port turns them into Python floats (``pipeline._intrinsics``), which a graph bakes in.
So the port keys a graph on their values.  A camera's values are fixed over a sequence,
so this costs one capture per camera.  A numpy array there keys apart from the tuple of
the same values and runs alike.  A CUDA tensor there, which JAX also takes, fails at the
capture (its value would be read on the host): pass camera values as numbers, tuples or
numpy arrays.  A bool ``handle_occlusions`` is keyed the same way; a tensor one is an
input (the host path passes tensors for it and for its line and point counts, which JAX
traces, so that one graph serves every value).

Static buffers.  Each tensor argument gets a buffer made before the capture, and each
call refills it with ``copy_``.  An expanded tensor keeps its zero strides: the buffer
holds its base (the tensor cut to one entry along each expanded dimension), which the
graph sees expanded again.  So a frame or a model that is expanded over a batch of 512
bodies costs one frame's or one model's copy per call.  A call skips the copy of a tensor
that is the very tensor it copied last time (the same object, alive, at the same
``_version``).

Outputs are cloned after each replay, as JAX returns fresh arrays: no state a caller
holds aliases a graph's buffer.  (The JAX package's scans donate their state, which lets
XLA update it in place; the port's scans replay one graph per step and take the clone.)

Capture.  The warm-up runs on a side stream, as PyTorch asks before a capture.  So every
lazy resource is made outside the capture: the cuBLAS and cuSOLVER handles and
workspaces, the kernel library (``ops/_cuda.py``) and the device scalars of
``ops/depth_fn.div_value``.  The graph reads those scalars by address, so it holds a
reference to each one it reads (:func:`hold`).  The capture then runs on the same stream.
A capture that fails raises, naming the function, the static key and the operation, and
nothing runs eagerly in its place: the capture is the test that the function reads
nothing back on the host.

Memory.  All graphs on a device allocate from one memory pool.  A capture takes memory
from the pool only for the tensors made inside it: its intermediates, which are dead
when the capture ends, and its outputs, which the graph keeps for as long as it lives.
A later capture may reuse the blocks of an earlier graph's intermediates, never its
outputs, and a replay writes only its own intermediates and outputs.  The graphs replay
one after another on the caller's stream (the port runs on one stream), so a block that
two graphs share as intermediates is dead in both between their replays.  Static
buffers, the outputs' clones and the warm-up's results come from the ordinary
allocator.  Graphs must therefore not be replayed concurrently on two streams.

Launch counters.  Each kernel wrapper counts its launches (``sample_lines.launches``
and the like; ``ops/_cuda.py`` declares the wrappers and counts their launches).  A
capture notes how many launches of each kernel it records (and takes them off again: a
capture launches nothing), and each replay adds them to the wrappers' counts.  So a
graphed call counts what its eager twin counts, the first call included.

A decorated function called during another one's warm-up or capture runs inline, as a
jitted function called inside a jit is traced into it.

Tracing (``utils/timing.py``).  Every call opens a call record while the tracer is on.
Its host spans are ``graphs.key`` (binding, the static key and the lookup, up to the
first enqueue), ``graphs.load``, ``graphs.replay`` and ``graphs.clone`` (a capture's
times are :class:`GraphInfo`'s); ``timing.collect`` is the tracer's own reading of the
last replay's marks.  A capture takes the function's stage marks (``timing.stage``)
into the graph as event-record nodes, after a ``graphs.run`` mark at the start of its
first segment and before an end mark after its last, whatever the tracer's state: one
graph serves both, so that a profiler started after the capture times the graph it
profiles.  The nodes cost every replay, traced or not, about 4 us each on an H100 (the
region cycle's 46 marks 0.20 ms a replay at B=512, 1.4 %; 0.18 ms at B=1, 3.1 %).  A
traced replay adds the eager marks ``graphs.copy`` around the copies
into the static buffers and ``graphs.clone`` around the outputs' clones, so that its
stages tile it from the first copy to the last clone.  The graph's events are recorded
anew by every replay, so a traced replay's marks are read before the graph's next
replay (or by ``timing.report()``); :func:`clear_graphs` leaves what the tracer holds.
``_Graph.load`` counts the bytes it copies, ``graphs.copy_bytes``; the counts that the
function makes (``timing.count``) are taken into the graph at its capture and counted
again by every replay.

Collectives between captured segments.  The JAX package's multi-camera cycles sum their
cameras' terms with a ``psum`` inside the jitted program.  A CUDA graph cannot hold a
gloo collective, so a graphed function calls its collective through :func:`collective`:
``collective(fn, tensor)`` runs ``fn(tensor)`` (an in-place operation such as
``torch.distributed.all_reduce``) where it stands when nothing is being captured (eager,
on the CPU, in the warm-up, under :func:`disable_graphs`).  Inside a capture it ends the
current segment (a ``torch.cuda.CUDAGraph``), records ``(fn, tensor)`` without running
it (the tensor holds no values yet), and begins the next segment in the same pool on the
same stream.  A replay then runs segment 0, ``fn(t0)``, segment 1, ``fn(t1)``, .. in
capture order on the caller's stream.  Every rank captures the same sequence, so the
ranks' collectives stay matched.  Sharing the pool between segments is safe for the
reasons that make it safe between graphs (above): the segments replay one after
another, in capture order, on one stream; and a tensor that one segment writes and a
later one reads is a Python reference of the captured function until its last use, so
no allocation of the capture takes its block before that.  The collective's tensor is
held by the graph as long as it lives, so its address is the same in every replay.  A
function with no collective is one segment; :class:`GraphInfo` counts them, and the
launch counts cover every segment.  (With NCCL the collective could be captured inside
the graph instead; one mechanism serves both backends.)
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from m3t_tpu_torch.ops import _cuda
from m3t_tpu_torch.utils import timing

_TORCH = str(Path(torch.__file__).resolve().parent)


class GraphInfo(NamedTuple):
    """What one captured graph cost and did."""

    name: str  # the decorated function's qualified name
    warmup_s: float  # the first call's eager run, host seconds to its end on the device
    capture_s: float  # capture and instantiation, host seconds
    replays: int
    launches: dict  # kernel wrapper name -> launches per replay
    segments: int  # captured segments, one more than the collectives between them


class _Local(threading.local):
    disabled = 0  # disable_graphs() depth
    tracing = False  # inside a warm-up or a capture
    capture = None  # the _Graph being captured, else None


_local = _Local()
_GRAPHS: dict = {}  # static key -> _Graph
_STREAMS: dict = {}  # device -> side stream for warm-ups and captures
_POOLS: dict = {}  # device -> the graphs' shared memory pool


@contextlib.contextmanager
def disable_graphs():
    """Run decorated functions eagerly inside the block (``jax.disable_jit()``); nests."""
    _local.disabled += 1
    try:
        yield
    finally:
        _local.disabled -= 1


def graphs_enabled() -> bool:
    """False inside :func:`disable_graphs`."""
    return _local.disabled == 0


def clear_graphs() -> None:
    """Drop every captured graph, its buffers and its pool (``jax.clear_caches()``)."""
    if _GRAPHS and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _GRAPHS.clear()
    _POOLS.clear()


def captured() -> list[GraphInfo]:
    """The graphs captured since the last :func:`clear_graphs`, in capture order."""
    return [entry.info() for entry in _GRAPHS.values()]


def capturing() -> bool:
    """True while a graph is being captured on this thread."""
    return _local.capture is not None


def hold(tensor: torch.Tensor) -> None:
    """Keep a tensor made outside the capture alive as long as the graph being captured,
    which reads it by address.  Nothing outside a capture."""
    if _local.capture is not None:
        _local.capture.held.append(tensor)


def collective(fn, tensor: torch.Tensor) -> None:
    """fn(tensor), an in-place collective, between two captured segments of the graph
    being captured (replayed between them), else at once (see the module docstring)."""
    entry = _local.capture
    if entry is None:
        fn(tensor)
        return
    entry.segments[-1].capture_end()
    entry.collectives.append((fn, tensor))
    entry.begin_segment()


def _expanded(t: torch.Tensor) -> tuple:
    return tuple(size > 1 and stride == 0 for size, stride in zip(t.shape, t.stride()))


def _base(t: torch.Tensor) -> torch.Tensor:
    """t cut to its first entry along every expanded dimension (a view)."""
    for dim, expanded in enumerate(_expanded(t)):
        if expanded:
            t = t.narrow(dim, 0, 1)
    return t


def static_buffer(t: torch.Tensor):
    """(base, view): the buffer a graph keeps for an argument like t, and the view of it
    that the graph reads.  base holds one entry along each of t's expanded dimensions (in
    t's layout where t's base is dense); view is base expanded to t's shape."""
    base = torch.empty_like(_base(t))
    return base, base.expand(t.shape)


def _spec(x, leaves: list, where: str):
    """The hashable key of an argument; its tensors are appended to leaves in order."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return (torch.Tensor, tuple(x.shape), x.dtype, x.device, _expanded(x))
    if isinstance(x, tuple):
        return (type(x), tuple(_spec(v, leaves, f"{where}[{i}]") for i, v in enumerate(x)))
    if isinstance(x, list):
        return (list, tuple(_spec(v, leaves, f"{where}[{i}]") for i, v in enumerate(x)))
    if x is None or isinstance(x, (bool, int, float, np.generic)):
        return (type(x), repr(x))  # repr tells 0.0 from -0.0 and matches nan to nan
    if isinstance(x, np.ndarray):
        return (np.ndarray, x.shape, x.dtype.str, x.tobytes())
    raise TypeError(f"graphed: cannot key argument {where} of type {type(x).__name__}")


def _map_tensors(fn, x):
    """x with every tensor t replaced by fn(t), in _spec's order."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        items = [_map_tensors(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if isinstance(x, list):
        return [_map_tensors(fn, v) for v in x]
    return x


def _tensors(x) -> list:
    found = []
    _map_tensors(found.append, x)
    return found


def _call_key(fn, bound: inspect.BoundArguments, static: frozenset):
    leaves = []
    key = [fn]
    for name, value in bound.arguments.items():
        if name in static:
            try:
                hash(value)
            except TypeError as err:
                raise TypeError(f"graphed {fn.__qualname__}: static argument {name} must "
                                f"be hashable") from err
            key.append((name, value))
        else:
            key.append((name, _spec(value, leaves, name)))
    return tuple(key), leaves


def static_key(fn, *args, **kwargs):
    """The static key of fn(*args, **kwargs), fn a :func:`graphed` function."""
    return _call_key(fn.__wrapped__, _bind(fn.__wrapped__, args, kwargs),
                     fn.static_argnames)[0]


def _bind(fn, args, kwargs) -> inspect.BoundArguments:
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    return bound


def _describe(bound: inspect.BoundArguments, static: frozenset) -> str:
    """A readable static key: tensors as dtype[shape]@device, expanded dimensions
    marked with an x."""
    def short(x):
        if isinstance(x, torch.Tensor):
            dims = ",".join(f"{n}x" if e else str(n) for n, e in zip(x.shape, _expanded(x)))
            return f"{str(x.dtype).removeprefix('torch.')}[{dims}]@{x.device}"
        if isinstance(x, (tuple, list)):
            inner = ", ".join(short(v) for v in x)
            return f"{type(x).__name__}({inner})"
        return repr(x)

    return ", ".join(f"{name}={value!r}" if name in static else f"{name}={short(value)}"
                     for name, value in bound.arguments.items())


def _where(err: BaseException) -> str:
    """file:line (source) of the innermost frame outside this module and outside
    PyTorch, in the first exception of err's chain that has one."""
    chain, e = [], err
    while e is not None and all(e is not c for c in chain):
        chain.append(e)
        e = e.__cause__ or e.__context__
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename != __file__ and not f.filename.startswith(_TORCH)]
        if frames:
            return f"{frames[-1].filename}:{frames[-1].lineno} ({frames[-1].line})"
    return "an operation of PyTorch's"


def _version(t: torch.Tensor):
    try:
        return t._version
    except RuntimeError:  # inference tensors have no version counter: always copy
        return None


@contextlib.contextmanager
def _tracing(capture=None):
    saved = _local.tracing, _local.capture
    _local.tracing, _local.capture = True, capture
    try:
        yield
    finally:
        _local.tracing, _local.capture = saved


class _Graph:
    """One captured graph: its static buffers, segments and the collectives between
    them, outputs, held tensors and counts."""

    def __init__(self, name, leaves):
        self.name = name
        self.buffers = [static_buffer(t) for t in leaves]
        self.sources = [None] * len(leaves)  # (weakref, version) of the last copy
        self.segments = []  # torch.cuda.CUDAGraph, in capture order
        self.collectives = []  # (fn, tensor) after each segment but the last
        self.pool = self.outputs = None
        self.held = []
        self.launches = []  # (kernel wrapper, launches per replay) with launches > 0
        self.warmup_s = self.capture_s = 0.0
        self.replays = 0
        self.marks = []  # the captured stage marks, [(name, external event)]
        self.counts = []  # the captured counts, [(name, n)], counted by every replay
        self.pending = None  # the call record of a traced replay, its marks unread

    def info(self) -> GraphInfo:
        return GraphInfo(self.name, self.warmup_s, self.capture_s, self.replays,
                         {fn.__name__: n for fn, n in self.launches}, len(self.segments))

    def begin_segment(self) -> None:
        self.segments.append(torch.cuda.CUDAGraph())
        self.segments[-1].capture_begin(pool=self.pool)

    def load(self, leaves) -> None:
        """Copy every argument into its buffer, skipping one copied unchanged (the
        bytes copied counted by the tracer: ``graphs.copy_bytes``)."""
        copied = 0
        for i, (t, (base, _)) in enumerate(zip(leaves, self.buffers)):
            last, version = self.sources[i] or (None, None)
            if last is not None and last() is t and version is not None \
                    and _version(t) == version:
                continue
            base.copy_(_base(t))
            copied += base.numel() * base.element_size()
            self.sources[i] = (weakref.ref(t), _version(t))
        timing.count("graphs.copy_bytes", copied)

    def replay(self, leaves, record=None):
        """Copy, replay and clone; ``record`` (a traced call's) takes the marks: the
        copies', the graph's own and the clones'."""
        if self.pending is not None:
            with timing.span("timing.collect"):
                timing.TRACER.collect(self.pending)
            self.pending = None
        if record is not None:
            record.open("replay", self.buffers[0][0].device)
        with timing.span("graphs.load"):
            timing.stage("graphs.copy")
            self.load(leaves)
            timing.stage(None)
        if record is not None:
            record.marks.extend(self.marks)
        with timing.span("graphs.replay"):
            for i, segment in enumerate(self.segments):
                segment.replay()
                if i < len(self.collectives):
                    fn, tensor = self.collectives[i]
                    fn(tensor)
        for fn, n in self.launches:
            fn.launches += n
        for name, n in self.counts:
            timing.count(name, n)
        self.replays += 1
        with timing.span("graphs.clone"):
            timing.stage("graphs.clone")
            outputs = _map_tensors(torch.clone, self.outputs)
            timing.stage(None)
        if record is not None:
            self.pending = record
        return outputs


def _abandon_pool(device) -> None:
    """After a failed capture: stop allocating to its pool, which PyTorch leaves undone
    when the capture cannot end, and give later captures a pool of their own."""
    pool = _POOLS.pop(device)
    with contextlib.suppress(RuntimeError):  # raises if the capture's end did it
        torch._C._cuda_endAllocateToPool(device.index, pool)


def _capture(fn, bound: inspect.BoundArguments, static: frozenset, leaves: list,
             record=None):
    """Warm fn up on the static buffers, capture it, and return (graph, warm-up result).
    The capture takes fn's stage marks into the graph, with a ``graphs.run`` mark at its
    start and an end mark after its last segment; ``record`` (a traced call's) takes the
    warm-up's marks."""
    device = leaves[0].device
    entry = _Graph(fn.__qualname__, leaves)
    if record is not None:
        record.open("capture", device)
    entry.load(leaves)
    views = iter([view for _, view in entry.buffers])
    args = bound.signature.bind(**{name: _map_tensors(lambda _: next(views), value)
                                   for name, value in bound.arguments.items()})
    with torch.cuda.device(device):
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device)
        if device not in _POOLS:
            _POOLS[device] = torch.cuda.graph_pool_handle()
        side, main = _STREAMS[device], torch.cuda.current_stream(device)
        begin = time.perf_counter()
        side.wait_stream(main)
        with _tracing(), torch.cuda.stream(side):
            timing.stage("graphs.run")
            warm = fn(*args.args, **args.kwargs)
            timing.stage(None)
        main.wait_stream(side)
        for t in _tensors(warm):
            t.record_stream(main)
        # A fresh copy: a result may be a static buffer (a state returned unchanged).
        result = _map_tensors(torch.clone, warm)
        del warm
        torch.cuda.synchronize(device)
        entry.warmup_s = time.perf_counter() - begin

        torch.cuda.empty_cache()
        counts = {fn: fn.launches for fn in _cuda.wrappers()}
        entry.pool = _POOLS[device]
        begin = time.perf_counter()
        try:
            with _tracing(entry), timing.capturing(entry.marks, entry.counts), \
                    torch.cuda.stream(side):
                entry.begin_segment()
                try:
                    timing.stage("graphs.run")
                    outputs = fn(*args.args, **args.kwargs)
                    timing.stage(None)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        entry.segments[-1].capture_end()
                    raise
                entry.segments[-1].capture_end()
        except Exception as err:
            _abandon_pool(device)
            raise RuntimeError(
                f"graphed {entry.name}: capturing its CUDA graph failed at {_where(err)} "
                f"for the static key ({_describe(bound, static)}): {err}") from err
        finally:
            launched = {fn: fn.launches for fn in _cuda.wrappers()}
            for fn in launched:  # as before the capture; 0 if declared during it
                fn.launches = counts.get(fn, 0)
        entry.capture_s = time.perf_counter() - begin
    entry.outputs = outputs
    entry.launches = [(fn, n - counts.get(fn, 0)) for fn, n in launched.items()
                      if n > counts.get(fn, 0)]
    return entry, result


def _lookup(fn, static: frozenset, args, kwargs):
    """The device to run fn eagerly on (graphs disabled, or CPU tensors), else (the
    graph of the call's static key or None, the key, the bound arguments, the
    tensors)."""
    bound = _bind(fn, args, kwargs)
    devices = {t.device for t in _tensors(list(bound.arguments.values()))}
    if _local.disabled or all(d.type == "cpu" for d in devices):
        return next(iter(devices), torch.device("cpu"))
    key, leaves = _call_key(fn, bound, static)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"graphed {fn.__qualname__}: its tensors must lie on one "
                         f"CUDA device or on the CPU, not on "
                         f"{sorted(map(str, devices))}")
    return _GRAPHS.get(key), key, bound, leaves


def _eager(fn, args, kwargs, device, record):
    """fn run as it is, its marks taken into ``record`` (a traced call's)."""
    if record is None:
        return fn(*args, **kwargs)
    record.open("eager", device)
    timing.stage("graphs.run")
    result = fn(*args, **kwargs)
    timing.stage(None)
    return result


def graphed(static_argnames=()):
    """Decorator: on CUDA tensors, one CUDA graph per static key of the call (see the
    module docstring); on CPU tensors, the function itself."""
    static = frozenset(static_argnames)

    def decorate(fn):
        unknown = static - set(inspect.signature(fn).parameters)
        if unknown:
            raise ValueError(f"graphed {fn.__qualname__}: no parameters {sorted(unknown)}")

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _local.tracing or (_local.disabled and not timing.enabled()):
                return fn(*args, **kwargs)
            with timing.call(fn.__qualname__) as record:
                with timing.span("graphs.key"):
                    found = _lookup(fn, static, args, kwargs)
                if isinstance(found, torch.device):
                    return _eager(fn, args, kwargs, found, record)
                entry, key, bound, leaves = found
                if entry is None:
                    entry, result = _capture(fn, bound, static, leaves, record)
                    _GRAPHS[key] = entry
                    return result
                return entry.replay(leaves, record)

        call.static_argnames = static
        return call

    return decorate
