"""CUDA graphs of the frame chain, with the kernels' launch counts kept
true: the ISM describe sized on the device (`ChunkGraphs`, one IF
conditional node a 16-crop chunk, `csrc/describe_graph.cu`) and the
segmentor's device AMG captured whole (`StaticGraph`).

The JAX package describes only the first ceil(n_needed / chunk) chunks of
its proposal buffer, n_needed a device scalar, through a data-dependent
`lax.while_loop` or one `lax.cond` a chunk (`sam6d_tpu/pipelines/ism.py:
82-143`); the host never reads the valid flags. `ChunkGraphs` is the
counterpart of the `lax.cond` a chunk on the card:

- each chunk's forward is captured into a CUDA graph of its own (body c
  reads chunk c of a static crop buffer and writes chunk c of static
  cls / patch outputs); the bodies share one memory pool and run in chunk
  order;
- `csrc/describe_graph.cu` composes them under a parent graph: a memset
  of the outputs (chunks past the prefix stay zero, as in JAX), a small
  kernel that sets each chunk's handle from n_needed with
  `cudaGraphSetConditional`, then one IF node a chunk holding its body;
- a run copies the crops and n_needed into the static buffers on the
  stream and launches the parent graph: no host read, and the same
  ceil(n_needed / chunk) chunks of work as the eager loop.

`StaticGraph` captures a call whose work does not depend on the data (the
AMG of one frame geometry: encoder, iou pass, decode, NMS, gather): JAX
runs it as one jitted program; on the card it is one graph launch instead
of thousands of kernel launches, which a frame would otherwise queue
faster than the card's launch queue drains, so that the host blocked on
the queue behind the card.

Each graph is built once by its caller and replayed after that. The
one-time set-up of every kernel (its `cudaFuncSetAttribute`, cuBLAS's
handles, a kernel's first load) and of every constant the call uploads
runs in an eager warm-up call before the capture. A graph that does not
build raises.

Launch counts. A kernel wrapper counts its launches when Python calls it,
which for a graph happens once, at capture. The captures' counts are
taken back out; a StaticGraph adds its captured launches at each run, a
ChunkGraphs keeps the launches of one chunk body (`per_chunk`) and a
device counter of the chunks its runs executed, and
`settle_graph_launches()` (a host read, for tests and measurement, never
on the frame chain) adds chunks x launches to each wrapper's count.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from ._build import check, load_library

# cudaGraphNodeType values (driver_types.h)
NODE_TYPE_NAMES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "child graph",
                   5: "empty", 6: "event wait", 7: "event record",
                   8: "semaphore signal", 9: "semaphore wait", 10: "mem alloc",
                   11: "mem free", 12: "batch mem op", 13: "conditional"}

# (the graph, weakly; its device counter of chunk runs; its launches a
# chunk) for every ChunkGraphs built: a counter outlives its graph until
# settle_graph_launches has read it
_CHUNK_RUNS = []


def kernel_counters():
    """Every kernel wrapper of the package that counts its launches."""
    from . import attention, attention_qkv, attention_relpos, ball_query, factored, fps, nms
    fns = []
    for mod in (attention, attention_qkv, attention_relpos, ball_query, factored, fps, nms):
        for name in sorted(vars(mod)):
            fn = getattr(mod, name)
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                fns.append(fn)
    return fns


class _counts_taken_back:
    """Inside the block, kernel launches are counted into `self.launches`
    (wrapper -> launches of the block) and taken back out of the
    wrappers' own counts when it ends."""

    def __enter__(self):
        self._counters = kernel_counters()
        self._before = [fn.launches for fn in self._counters]
        return self

    def __exit__(self, *exc):
        self.launches = {fn: fn.launches - b for fn, b in zip(self._counters, self._before)
                         if fn.launches != b}
        for fn, b in zip(self._counters, self._before):
            fn.launches = b


def _warm_up(fn, args, side):
    """fn(*args) once on the side stream, outside any capture."""
    dev = side.device
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        out = fn(*args)
    torch.cuda.current_stream(dev).wait_stream(side)
    return out


class StaticGraph:
    """`fn(*inputs)` captured once as a CUDA graph on static copies of
    `examples`; run(*inputs) copies the inputs into them on the stream,
    replays the graph and returns copies of its outputs (the next run
    rewrites them). Each run adds the captured call's launches to the
    kernel wrappers' counts."""

    def __init__(self, fn, examples):
        dev = examples[0].device
        if dev.type != "cuda":
            raise ValueError("StaticGraph captures CUDA work: the inputs must be on the card")
        self.inputs = [torch.zeros_like(x) for x in examples]
        side = torch.cuda.Stream(dev)
        with _counts_taken_back():
            _warm_up(fn, self.inputs, side)
        self.graph = torch.cuda.CUDAGraph()
        with _counts_taken_back() as captured:
            with torch.cuda.graph(self.graph, stream=side):
                self.outputs = fn(*self.inputs)
        self.per_run = captured.launches

    def run(self, *inputs):
        with torch.inference_mode():   # the buffers may be inference tensors
            for static, x in zip(self.inputs, inputs):
                static.copy_(x)
            self.graph.replay()
        for fn, k in self.per_run.items():
            fn.launches += k
        return tuple(o.clone() for o in self.outputs)


class ChunkGraphs:
    """`forward` ((chunk, *crop) -> (cls, patch)) over n_chunks chunks of a
    static crop buffer shaped and typed like `example`, as one parent graph
    with an IF node a chunk; `run(images, n_needed)` returns (cls (n_chunks,
    chunk, ...), patch (n_chunks, chunk, ...)), the chunks past
    ceil(n_needed / chunk) zero."""

    def __init__(self, forward, example: torch.Tensor, n_chunks: int, chunk: int):
        dev = example.device
        if dev.type != "cuda":
            raise ValueError("ChunkGraphs captures CUDA work: the crops must be on the card")
        self.chunk, self.n_chunks = chunk, n_chunks
        self.crops = torch.zeros((n_chunks * chunk, *example.shape[1:]), dtype=example.dtype,
                                 device=dev)
        self.n_needed = torch.zeros((), dtype=torch.int32, device=dev)
        self.trips = torch.zeros((), dtype=torch.int64, device=dev)
        xs = self.crops.view(n_chunks, chunk, *example.shape[1:])
        side = torch.cuda.Stream(dev)
        with _counts_taken_back():
            cls0, patch0 = _warm_up(forward, (xs[0],), side)
        self.cls = torch.zeros((n_chunks, *cls0.shape), dtype=cls0.dtype, device=dev)
        self.patch = torch.zeros((n_chunks, *patch0.shape), dtype=patch0.dtype, device=dev)
        del cls0, patch0
        self._graphs, pool = [], None
        for c in range(n_chunks):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with _counts_taken_back() as captured:
                with torch.cuda.graph(g, pool=pool, stream=side):
                    cc, pc = forward(xs[c])
                    self.cls[c].copy_(cc)
                    self.patch[c].copy_(pc)
            del cc, pc
            if pool is None:
                pool = g.pool()
                self.per_chunk = captured.launches
            self._graphs.append(g)
        lib = load_library()
        bodies = (ctypes.c_void_p * n_chunks)(*[g.raw_cuda_graph() for g in self._graphs])
        outs = (self.cls, self.patch)
        zero_ptrs = (ctypes.c_void_p * 2)(*[t.data_ptr() for t in outs])
        zero_bytes = (ctypes.c_longlong * 2)(*[t.numel() * t.element_size() for t in outs])
        n_types = lib.sam6d_describe_graph_node_types()
        counts = (ctypes.c_int * n_types)()
        exec_, graph = ctypes.c_void_p(), ctypes.c_void_p()
        err = lib.sam6d_describe_graph_build(bodies, n_chunks, zero_ptrs, zero_bytes, 2,
                                             self.n_needed.data_ptr(), chunk,
                                             ctypes.byref(exec_), ctypes.byref(graph), counts)
        check(err, f"building the describe graph ({n_chunks} IF nodes of {chunk} crops)")
        self._exec, self._graph, self._lib = exec_.value, graph.value, lib
        # the node types the conditional bodies hold (all of them accepted)
        self.node_types = {NODE_TYPE_NAMES.get(t, str(t)): counts[t]
                           for t in range(n_types) if counts[t]}
        _CHUNK_RUNS.append((weakref.ref(self), self.trips, self.per_chunk))

    def run(self, images: torch.Tensor, n_needed: torch.Tensor):
        """Describe the first ceil(n_needed / chunk) chunks of `images`
        (n_chunks * chunk crops) on the current stream, no host read."""
        with torch.inference_mode():   # the buffers may be inference tensors
            self.crops.copy_(images)
            self.n_needed.copy_(n_needed)
            stream = torch.cuda.current_stream(self.crops.device).cuda_stream
            check(self._lib.sam6d_describe_graph_launch(self._exec, stream),
                  "describe graph launch")
            self.trips += torch.clamp((self.n_needed + self.chunk - 1) // self.chunk,
                                      max=self.n_chunks)
        # the outputs are rewritten by the next run: the caller gets copies
        return self.cls.clone(), self.patch.clone()

    def __del__(self):
        if getattr(self, "_exec", None):
            self._lib.sam6d_describe_graph_destroy(self._exec, self._graph)
            self._exec = None


def settle_graph_launches() -> None:
    """Add each describe graph's chunk runs (chunks x launches a chunk) to
    the kernel wrappers' counts and zero its device counter, also for a
    graph that no longer exists. Reads the counters on the host: for tests
    and measurement, after the work they count."""
    for entry in list(_CHUNK_RUNS):
        graph, trips, per_chunk = entry
        n = int(trips)
        if n:
            with torch.inference_mode():   # the counter may be an inference tensor
                trips.zero_()
            for fn, k in per_chunk.items():
                fn.launches += n * k
        if graph() is None:
            _CHUNK_RUNS.remove(entry)
