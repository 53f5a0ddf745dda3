"""Eager steps replayed as CUDA graphs on a card, shared by the
motion-only solve (models/ba.py `pose_optimize`, `replay`) and local
mapping (models/mapping.py `mapping_step`, `replay_state`). Both keep a
step's graphs by what a capture bakes in (the caller's key and the float
settings), copy a call's inputs into the graph's static ones and replay;
each caller keeps only its cache, its key and its eager body. `replay`
returns copies of the outputs. `replay_state` is for a step that maps a
state to its next value: the graph writes the new state over its static
input, and the call returns aliases of it, so the state is held once, not
three times (the caller's, the graph's input and its output)."""

from __future__ import annotations

import weakref
from typing import Callable, Collection, NamedTuple, Sequence, Tuple, TypeVar

import torch

from .profiling import span

T = TypeVar("T")


class Captured(NamedTuple):
    """One step captured as a CUDA graph: its static inputs, the graph, and
    what the captured run returned (the tensors each replay writes)."""

    inputs: tuple
    graph: object            # torch.cuda.CUDAGraph
    out: tuple


def precision() -> tuple:
    """The process-wide float settings that a captured kernel keeps (a
    TF32 matmul stays one after the setting changes)."""
    matmul = torch.backends.cuda.matmul
    return (torch.get_float32_matmul_precision(), matmul.allow_tf32,
            matmul.allow_fp16_reduced_precision_reduction,
            matmul.allow_bf16_reduced_precision_reduction, torch.backends.cudnn.allow_tf32)


def capture(run: Callable[[], T], device: torch.device) -> Tuple[object, T]:
    """`run()` once as is (the lazy handles of its kernels, its cached
    constants, the libraries' handles), then captured on a side stream,
    as `torch.cuda.graph` does but without its synchronize (the capture
    reads nothing back) and in thread-local mode (another thread's CUDA
    calls do not break it). Returns (the `torch.cuda.CUDAGraph`, what the
    captured run returned: the tensors each replay writes).

    The cuBLAS workspace that the capture allocates for its stream (32 MiB
    on an H100) is dropped from cuBLAS's table afterwards: the graph keeps
    using it inside its private pool, which nothing else draws from, and
    the allocated memory stays what the step op by op needs. (The current
    stream's workspace is made again at its next cuBLAS call.)"""
    run()
    stream = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = run()
        finally:
            graph.capture_end()
    stream.wait_stream(side)
    torch._C._cuda_clearCublasWorkspaces()
    return graph, out


def _static(inputs: Sequence[torch.Tensor], unread: Collection[int]) -> tuple:
    """Contiguous copies of the inputs; meta placeholders of those at the
    positions `unread` (no op on the card takes one)."""
    return tuple(torch.empty(t.shape, dtype=t.dtype, device="meta") if i in unread
                 else t.clone(memory_format=torch.contiguous_format)
                 for i, t in enumerate(inputs))


def _device(static: tuple) -> torch.device:
    return next(t.device for t in static if not t.is_meta)


def _lookup(graphs: dict, key, name: str, make: Callable[[], T]) -> T:
    """The step `graphs` keeps under `key` and the float settings; a
    key's first call captures it (`make()`, span `<name>.capture`)."""
    key = (key, precision())
    step = graphs.get(key)
    if step is None:
        with span(f"{name}.capture"):
            step = graphs[key] = make()
    return step


def _capture_outputs(run: Callable[..., T], inputs: Sequence[torch.Tensor]) -> Captured:
    static = _static(inputs, ())
    graph, out = capture(lambda: run(*static), _device(static))
    return Captured(static, graph, out)


def replay(graphs: dict, key, name: str, run: Callable[..., T],
           inputs: Sequence[torch.Tensor]) -> T:
    """`run(*inputs)` (a NamedTuple of tensors) on a card, through the
    graph that `graphs` keeps under `key` (`_lookup`). Every call copies
    the inputs into the graph's, replays it (span `<name>.replay`) and
    returns copies of the outputs."""
    step = _lookup(graphs, key, name, lambda: _capture_outputs(run, inputs))
    with span(f"{name}.replay"):
        for buf, t in zip(step.inputs, inputs):
            buf.copy_(t)
        step.graph.replay()
        return type(step.out)(*(o.clone() for o in step.out))


class _State:
    """One state step captured as a CUDA graph: the static state (None for
    an input the step never reads), the graph, the NamedTuple type of the
    state and its length, the positions the step writes, and for each
    input a weak reference to the alias of its buffer last returned."""

    def __init__(self, run: Callable[..., T], inputs: Sequence[torch.Tensor],
                 unread: Collection[int]):
        static = _static(inputs, unread)
        shape = []

        def step():
            out = run(*static)
            written = []
            for i, (s, o) in enumerate(zip(static, out)):
                if o is not s:
                    if s.is_meta:
                        raise ValueError(f"the step writes output {i}, whose input it never reads")
                    s.copy_(o)
                    written.append(i)
            shape[:] = [type(out), len(out), frozenset(written)]

        self.graph, _ = capture(step, _device(static))
        self.kind, self.n_out, self.written = shape
        self.bufs = tuple(None if t.is_meta else t for t in static)
        self.held = [None] * self.n_out


def _alias(buf: torch.Tensor) -> torch.Tensor:
    """A tensor of its own over `buf`'s memory (`set_` can move it off)."""
    return torch.empty(0, dtype=buf.dtype, device=buf.device).set_(
        buf.untyped_storage(), buf.storage_offset(), buf.shape, buf.stride())


def _tensors_on(buf: torch.Tensor) -> int:
    """How many tensors share `buf`'s memory, `buf` included."""
    return torch._C._storage_Use_Count(buf.untyped_storage()._cdata) - 1


def replay_state(graphs: dict, key, name: str, run: Callable[..., T],
                 inputs: Sequence[torch.Tensor], unread: Collection[int] = ()) -> T:
    """`run(*inputs)` on a card for a step whose output (a NamedTuple) is
    the new value of the first `len(output)` inputs, field by field,
    through the graph that `graphs` keeps under `key` (`_lookup`). The
    inputs at the positions `unread`, which `run` never reads, are meta
    placeholders in the capture, are never copied, and pass through.

    The graph writes each output the step changes over its input's static
    buffer, and the call returns aliases of the buffers. A call handed the
    aliases the last call returned copies nothing in for them. Before a
    replay overwrites a buffer, the alias last returned of it, where anyone
    still holds it, is moved onto a copy of its values (copy on write), so
    no tensor a call returned ever changes; a view taken of such an alias
    cannot be moved, and overwriting it raises instead (span
    `<name>.replay`)."""
    step = _lookup(graphs, key, name, lambda: _State(run, inputs, unread))
    with span(f"{name}.replay"):
        for buf, t in zip(step.bufs[step.n_out:], inputs[step.n_out:]):
            if buf is not None:
                buf.copy_(t)
        out = _hand_in(step, inputs, step.written, name)
        step.graph.replay()
        return out


def hand_in(graphs: dict, key, name: str, inputs: Sequence[torch.Tensor]):
    """The state of `inputs` (as `replay_state` takes them) moved into the
    buffers of the graph that `graphs` keeps under `key`, as a call would
    before its replay, and returned as aliases of them; None where no graph
    is kept. A state made elsewhere (a new session's) is then not held
    beside the graph's own until the next replay."""
    step = graphs.get((key, precision()))
    return None if step is None else _hand_in(step, inputs, frozenset(), name)


def _hand_in(step: _State, inputs: Sequence[torch.Tensor], written: frozenset, name: str):
    """Each field of the state into its buffer where the caller hands in
    another tensor than the alias last returned of it, or where the
    replay to come writes it (`written`), the alias still held moved onto
    a copy first; returns the state the step's buffers then hold."""
    out = list(inputs[:step.n_out])
    for i, buf in enumerate(step.bufs[:step.n_out]):
        if buf is None:
            continue
        held = None if step.held[i] is None else step.held[i]()
        fresh = inputs[i] is not held
        if fresh or i in written:
            if held is not None:
                held.set_(buf.clone())
                held = None
            if _tensors_on(buf) != 1:
                raise RuntimeError(
                    f"{name}: a view of a tensor an earlier call returned is still "
                    f"held, and this call would overwrite it (input {i})")
            if fresh:
                buf.copy_(inputs[i])
            held = _alias(buf)
            step.held[i] = weakref.ref(held)
        out[i] = held
    return step.kind(*out)
