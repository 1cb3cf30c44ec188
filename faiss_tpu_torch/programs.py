"""Search programs: a search captured once per shape as a CUDA graph, then
replayed.

Counterpart of the compiled programs that ``faiss_tpu``'s TpuResources
caches (``faiss_tpu/index.py`` ``_build_search_fn``, ``ivf.py``
``_build_ivf_search_fn``): the whole search as one program, built once per
shape key, with no host work between its stages.

``call(index, kind, fn, static, inputs)`` is how an index runs one, keyed
by what its function is built from: the static numbers it reads, the
inputs' shapes and the index's generation, which every mutation bumps.
Under ``eager()`` the function runs directly, with no program.

``build(fn, inputs, device)`` takes an eager function of static-shaped
tensors, returning a tensor or a tuple of tensors, and the first call's
inputs, and returns (program, the first call's result). On the CPU the
program is ``fn`` itself, which runs the
kernels' plain versions (the counterpart of ``interpret=True``). On a CUDA
device:

  * the inputs are copied into the program's static buffers on the
    current stream;
  * ``fn`` runs once eagerly on a side stream (the warm-up: the kernels'
    library is loaded and their attributes set before any capture), and
    its result is the first call's result;
  * ``fn`` is captured on that stream into a ``torch.cuda.CUDAGraph``. The
    capture runs nothing. It bakes the addresses of every tensor ``fn``
    reads and every Python number it was built with, so a program is keyed
    by all of them (``call``'s key);
  * each later call copies its inputs into the static buffers on the
    current stream, replays the graph there and returns a clone of the
    static output (of each, for a tuple), which the next replay cannot
    overwrite: tokens in flight each hold their own result.

A host synchronisation inside the capture raises; nothing falls back to
eager. Kernel launches are counted in Python (``ops.kernels.launches``),
which a replay does not run: a program records the counts its capture
would have added and adds them on every replay, so the counts stay those
of an eager run.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import weakref
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from . import tracing
from .ops import kernels

# one capture at a time: each runs in "thread_local" mode, which forbids
# unsafe calls on the capturing thread only
_CAPTURE_LOCK = threading.Lock()
_owners = itertools.count()


class _Local(threading.local):
    eager = False       # per thread: ``call`` runs its functions eagerly


_local = _Local()

Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def new_owner(index) -> int:
    """A process-unique id for programs of ``index`` (keys are (kind,
    owner, generation, ...)), whose entries leave ``index.res`` when the
    index is collected."""
    owner = next(_owners)
    weakref.finalize(index, index.res.discard, owned_by(owner))
    return owner


def owned_by(owner: int) -> Callable[[object], bool]:
    """The predicate of ``TorchResources.discard`` for ``owner``'s keys."""
    return lambda key: (isinstance(key, tuple) and len(key) > 1
                        and key[1] == owner)


class GraphProgram:
    """One captured search: static inputs, the graph, its static output
    (a tensor or a tuple of them) and the launch counts of one replay."""

    def __init__(self, graph: torch.cuda.CUDAGraph,
                 static_in: List[torch.Tensor], static_out: Outputs,
                 launches: Dict[str, int], device: torch.device):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.device = device
        # inputs, replay and clone of one call are enqueued together, and
        # a call on another stream first waits for the last one's stream
        self._lock = threading.Lock()
        self._stream = None

    def __call__(self, *inputs: torch.Tensor) -> Outputs:
        with torch.cuda.device(self.device), self._lock:
            stream = torch.cuda.current_stream()
            if self._stream is not None and self._stream != stream:
                stream.wait_stream(self._stream)
            self._stream = stream
            for dst, src in zip(self.static_in, inputs):
                dst.copy_(src, non_blocking=True)
            self.graph.replay()
            if isinstance(self.static_out, tuple):
                out = tuple(t.clone() for t in self.static_out)
            else:
                out = self.static_out.clone()
            for name, n in self.launches.items():
                kernels.launches[name] += n
        return out


def _capture(fn, static_in):
    """(graph, static output, the launch counts the capture added), the
    counts taken back out: a capture launches nothing."""
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK:
        before = dict(kernels.launches)
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn(*static_in)
        except BaseException:
            try:
                graph.capture_end()     # leave capture mode on the stream
            except RuntimeError:
                pass                    # the capture is invalid: the first
            raise                       # error is the one to report
        finally:
            delta = {n: kernels.launches[n] - c for n, c in before.items()
                     if kernels.launches[n] != c}
            for n, c in delta.items():
                kernels.launches[n] -= c
        graph.capture_end()
    return graph, out, delta


def build(fn: Callable[..., Outputs], inputs: Sequence[torch.Tensor],
          device) -> Tuple[Callable[..., Outputs], Outputs]:
    """(program, first result) of ``fn`` over ``inputs`` on ``device``: the
    eager ``fn`` on the CPU, a ``GraphProgram`` on a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        return fn, fn(*inputs)
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream()
        static_in = [torch.empty(t.shape, dtype=t.dtype, device=device)
                     for t in inputs]
        for dst, src in zip(static_in, inputs):
            dst.copy_(src, non_blocking=True)
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = fn(*static_in)
            graph, static_out, delta = _capture(fn, static_in)
        cur.wait_stream(side)
        for t in (first if isinstance(first, tuple) else (first,)):
            t.record_stream(cur)
    return GraphProgram(graph, static_in, static_out, delta, device), first


def call(index, kind: str, fn: Callable[..., Outputs], static: tuple,
         inputs: Sequence[torch.Tensor], *, owner=None, gen=None,
         device=None, suffix: tuple = ()) -> Outputs:
    """``fn(index, *static, *inputs)`` through the program that
    ``index.res`` caches under (kind, owner, gen, static, the inputs'
    shapes and dtypes) + ``suffix``: the owner and generation default to
    ``index._owner`` and ``index._gen``, the device to ``index.device``.
    ``static`` holds every Python number ``fn`` reads; everything else it
    reads is the index's own state, which the generation pins. Built on a
    miss (its first result is then this call's; a ``programs.capture``
    span), else replayed (``programs.replay``). Under ``eager()``: ``fn``
    run directly."""
    if _local.eager:
        return fn(index, *static, *inputs)
    key = (kind, index._owner if owner is None else owner,
           index._gen if gen is None else gen, static,
           tuple([(t.shape, t.dtype) for t in inputs])) + suffix
    first = []

    def builder():
        ref = weakref.ref(index)
        with tracing.span("programs.capture"):
            prog, out = build(lambda *ins: fn(ref(), *static, *ins), inputs,
                              index.device if device is None else device)
        first.append(out)
        return prog

    prog = index.res.cached(key, builder)
    if first:
        return first[0]
    with tracing.span("programs.replay"):
        return prog(*inputs)


@contextlib.contextmanager
def eager():
    """Within: every ``call`` on this thread runs its function eagerly,
    with no program and no cache entry (what a replay must equal bit for
    bit: the tests and ``chip_smoke.py``)."""
    before = _local.eager
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = before
