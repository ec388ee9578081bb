"""Captured CUDA graphs of the engine's step, one per batch-shape tier.

The counterpart of the JAX engine's compiled step (bossruns_tpu/models/
runs.py:296-305: ``jax.jit`` of ``_step``, ``_step_wire`` and
``_step_gated``, the state donated; parallel/mesh.py:202 for the sharded
map). The sims pad every batch into a few monotone shape tiers (io/coo.py
``_pad_len``, the sims' floors) so that one program serves each tier, and
the step's parameters are device tensors (StepParams), so no value of a
batch changes the program.

A key is (path, the inputs' shape signature, H4's window bound). Its first
occurrence runs the step body eagerly: the warm-up that loads the kernel
modules and makes H4's shared-memory opt-in outside any capture. Its second
captures the body into a ``torch.cuda.CUDAGraph`` over static buffers and
replays it; every later occurrence copies its inputs and parameters into
the key's static buffers (one launch for all of them) and replays. An
input that already is the static buffer (a wire the engine uploaded into
the key's own buffer) is not copied.

Static across replays:
  * the state, updated in place (the JAX engine's ``donate_argnums=(0,)``).
    The cache is bound to one state: a state whose tensors it has not seen
    (``state_from_numpy``, a checkpoint resume) drops every graph and is
    bound instead; its next step per key captures anew;
  * the parameters block, the batch inputs and the gated bits;
  * the outputs (aux.vec, threshold, and scores under debug_aux), in
    buffers allocated before capture, outside the graphs' memory pool. A
    replayed step's StepAux holds them: it is valid until the next replay
    of the same key.
Scratch the wrappers allocate while a step is captured comes from one pool
that all of a cache's graphs share: they replay one at a time, on one
stream, and nothing a replay leaves behind lives there.

There is no fallback: a capture or replay error raises. Capture records
kernel launches without making them, so the capturing thread's kernel calls
are counted apart (``ops.kernels.recording``), and every replay adds them to
the launch counts.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import dataclass

import torch

from ..ops import kernels as K
from .runs import StepAux, params_view


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` captured in a pool shared by a cache."""

    def __init__(self, pool):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool

    @staticmethod
    def new_pool():
        return torch.cuda.graph_pool_handle()

    def capture(self, fn) -> None:
        with torch.cuda.graph(self.graph, pool=self.pool):
            fn()

    def replay(self) -> None:
        self.graph.replay()


@dataclass
class _Entry:
    graph: object
    inputs: dict            # name -> static input tensor
    params: object          # StepParams over a static block
    outs: tuple             # static (vec, threshold, scores or None)
    launches: dict          # kernel -> launches one replay makes


def _state_key(state) -> tuple:
    """Addresses, shapes and dtypes of a state's tensors (a GenomeState of
    tensors, or of per-shard lists)."""
    out = []
    for f in state:
        for t in f if isinstance(f, (list, tuple)) else (f,):
            out.append((t.data_ptr(), tuple(t.shape), t.dtype))
    return tuple(out)


def signature(inputs: dict) -> tuple:
    """The shape signature of a step's inputs: (name, shape, dtype) each."""
    return tuple((k, tuple(v.shape), str(v.dtype)) for k, v in inputs.items())


class GraphCache:
    """The captured steps of one engine, keyed by path and shape tier.

    ``replays`` and ``eager`` count the steps of each path that replayed
    and that ran the body eagerly (a key's first occurrence); ``captures``
    lists (path, host ms) of every capture. ``graph`` makes one graph from
    the cache's pool (``CudaGraph``; the tests give a stand-in that records
    the body and reruns it on replay, so the static buffers' handling runs
    on the CPU too)."""

    def __init__(self, device, graph=CudaGraph):
        self.device = torch.device(device)
        self._graph = graph
        self.entries: dict[tuple, _Entry] = {}
        self._out_specs: dict[tuple, list] = {}
        self._state_key = None
        self._pool = None
        self.replays: Counter = Counter()
        self.eager: Counter = Counter()
        self.captures: list[tuple[str, float]] = []
        #: how the last step ran: "eager", "capture" (captured, then
        #: replayed) or "replay"
        self.last_mode = None
        self.wires: dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- wires ---

    def wire(self, spec, n_words: int) -> torch.Tensor:
        """The static device wire (uint32 [n_words]) of one wire spec: the
        buffer a packed batch of that tier is uploaded into."""
        with self._lock:
            w = self.wires.get(spec)
            if w is None:
                w = torch.empty(n_words, dtype=torch.uint32, device=self.device)
                self.wires[spec] = w
            elif w.shape[0] != n_words:
                raise ValueError(f"wire spec {spec} holds {w.shape[0]} words, got {n_words}")
            return w

    def _owned(self, t: torch.Tensor) -> bool:
        p = t.untyped_storage().data_ptr()
        return any(w.untyped_storage().data_ptr() == p for w in self.wires.values())

    # ------------------------------------------------------------- steps ---

    def clear(self) -> None:
        """Drop every graph, its static buffers and the pool."""
        self.entries.clear()
        self._pool = None
        self._state_key = None

    def stats(self) -> dict:
        return dict(replays=dict(self.replays), eager=dict(self.eager),
                    captures=len(self.captures), capture_ms=[ms for _, ms in self.captures],
                    graphs=len(self.entries))

    def run(self, path: str, state, inputs: dict, params, body, win_cap: int, tag=()):
        """One step of ``path``: ``body(state, inputs, params)`` (which
        returns (state, StepAux)) eagerly on the key's first occurrence,
        else the key's graph replayed with these inputs and params. ``tag``:
        anything else the body's program depends on (part of the key)."""
        skey = _state_key(state)
        if skey != self._state_key:  # another state: its addresses are not the graphs'
            self.clear()
            self._state_key = skey
        key = (path, signature(inputs), int(win_cap), tag)
        entry = self.entries.get(key)
        if entry is None:
            if key not in self._out_specs:
                state, aux = body(state, inputs, params)
                self._out_specs[key] = [None if t is None else (tuple(t.shape), t.dtype)
                                        for t in (aux.vec, aux.threshold, aux.scores)]
                self.eager[path] += 1
                self.last_mode = "eager"
                return state, aux
            entry = self._capture(key, state, inputs, params, body)
            self.last_mode = "capture"
        else:
            self.last_mode = "replay"
        pairs = [(entry.inputs[k], v) for k, v in inputs.items()]
        pairs.append((entry.params.block, params.block))
        pairs = [(dst, src) for dst, src in pairs if dst.data_ptr() != src.data_ptr()]
        if pairs:  # one launch: every input and the params as bytes
            torch._foreach_copy_([dst.reshape(-1).view(torch.uint8) for dst, _ in pairs],
                                 [src.reshape(-1).view(torch.uint8) for _, src in pairs])
        entry.graph.replay()
        K.add_launches(entry.launches)
        self.replays[path] += 1
        return state, StepAux(*entry.outs)

    def _capture(self, key, state, inputs, params, body) -> _Entry:
        """Capture ``body`` for ``key`` over static inputs, a static params
        block and static outputs, all allocated here, before the capture."""
        static_in = {k: v if self._owned(v) else v.clone() for k, v in inputs.items()}
        static_params = params_view(params.block.clone(), params.win_bucket)
        outs = tuple(None if spec is None else torch.empty(spec[0], dtype=spec[1],
                                                           device=self.device)
                     for spec in self._out_specs[key])
        if self._pool is None:
            self._pool = self._graph.new_pool()
        graph = self._graph(self._pool)

        def step():
            _, aux = body(state, static_in, static_params)
            for dst, src in zip(outs, (aux.vec, aux.threshold, aux.scores)):
                if dst is not None:
                    dst.copy_(src)

        t0 = time.perf_counter()
        with K.recording() as launches:  # recorded, not launched
            graph.capture(step)
        self.captures.append((key[0], 1000.0 * (time.perf_counter() - t0)))
        entry = _Entry(graph, static_in, static_params, outs, dict(launches))
        self.entries[key] = entry
        return entry

