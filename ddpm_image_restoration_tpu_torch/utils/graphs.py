"""Captured CUDA graphs per signature: what the sampler's solver loop
(diffusion/ddrm.py `DDRMSampler.run`) and the train step (train/steps.py
`make_train_step`) share. Each module keeps only its signature and its
body.

`GraphCache` holds the policy: a signature's first call runs eager (the
warm-up of autograd and of the cuBLAS, cuDNN and cuFFT plans), its second
captures the body as one graph (`CapturedGraph`) and replays it, later
calls replay. A replay copies the call's inputs into the graph's static
copies and returns copies of its outputs, so a caller that keeps them is
not handed memory the next replay rewrites.

The flash wrappers count their launches in Python, which a replay does not
run. So a capture takes back what its Python pass counted, and each replay
adds those launches again: the counters still count launches on the
device, the capture's own pass not included (nothing runs while a stream
is captured).
"""

from __future__ import annotations

import collections
from typing import Callable, Hashable, Iterable, Optional, Sequence

import torch

from ddpm_image_restoration_tpu_torch.ops.flash_attention import COUNTED_KERNELS

# signatures seen once (run eager) that a cache remembers
SEEN_SIGNATURES = 64


class CapturedGraph:
    """`body(*inputs)` captured as one CUDA graph over static copies of
    `inputs` (tensors, or None where there is none): `outputs` is the tuple
    the capture returned (in the graph's memory, rewritten by each replay),
    `launches` the flash launches the capture counted, per wrapper of
    COUNTED_KERNELS, `replays` the replays so far. Each CUDA generator in
    `generators` is registered with the graph, so every replay draws from
    it where an eager call would and advances it as far. `after`, when
    given, is called once the capture has ended; what it returns is called
    after every replay. A failed capture raises, with the counters, the
    current stream and every generator it drew from (those given and the
    device's default one) as they were: torch leaves a generator whose
    capture did not end marked as capturing, and its next draw raises, so
    each gets back a copy of its state from before the capture. (A graph
    captured earlier that draws from the default generator keeps advancing
    the state it registered, not the copy.)"""

    def __init__(self, body: Callable, inputs: Sequence[Optional[torch.Tensor]], pool=None,
                 generators: Iterable[Optional[torch.Generator]] = (),
                 after: Optional[Callable[[], Callable[[], None]]] = None):
        self.body = body  # keeps what the graph reads (schedule tensors, the state) alive
        self.inputs = tuple(None if z is None else z.clone() for z in inputs)
        self.graph = torch.cuda.CUDAGraph()
        gens = [g for g in generators if g is not None and g.device.type == "cuda"]
        for g in gens:
            with torch.cuda.device(g.device):
                self.graph.register_generator_state(g)
        gens.append(torch.cuda.default_generators[torch.cuda.current_device()])
        saved = [(g, g.clone_state()) for g in gens]
        stream = torch.cuda.current_stream()
        before = [fn.launches for fn in COUNTED_KERNELS]
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                self.outputs = tuple(body(*self.inputs))
        except BaseException:
            torch.cuda.set_stream(stream)  # torch.cuda.graph leaves its own when capture_end raises
            for g, state in saved:
                g.graphsafe_set_state(state)
            raise
        finally:
            captured = [fn.launches for fn in COUNTED_KERNELS]
            for fn, n in zip(COUNTED_KERNELS, before):
                fn.launches = n
        self.launches = [a - b for a, b in zip(captured, before)]
        self.after = None if after is None else after()
        self.replays = 0

    def replay(self, inputs: Sequence[Optional[torch.Tensor]]) -> tuple:
        """Copy `inputs` in, replay the graph on the current stream, count
        its launches; returns copies of the outputs."""
        for static, z in zip(self.inputs, inputs):
            if static is not None:
                static.copy_(z)
        self.graph.replay()
        self.replays += 1
        for fn, n in zip(COUNTED_KERNELS, self.launches):
            fn.launches += n
        if self.after is not None:
            self.after()
        return tuple(o.clone() for o in self.outputs)


class GraphCache:
    """Signature -> `CapturedGraph`, at most `size` graphs, the least
    recently replayed dropped first, before a new capture (each holds its
    activations' memory); signatures seen once are remembered up to
    SEEN_SIGNATURES. `shared_pool`: all graphs allocate from one memory
    pool (graphs that never run at once), else each from its own.
    `captures` counts the captures made."""

    def __init__(self, size: int, shared_pool: bool = False):
        self.size = size
        self.shared_pool = shared_pool
        self.pool = None
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.seen: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0

    def __call__(self, key: Hashable, body: Callable, inputs: Sequence[Optional[torch.Tensor]],
                 generators: Iterable[Optional[torch.Generator]] = (),
                 after: Optional[Callable[[], Callable[[], None]]] = None) -> tuple:
        """`body(*inputs)` for this call of signature `key`: eager on the
        signature's first call, else a replay of its graph (captured on
        the second call; `generators` and `after` as `CapturedGraph`)."""
        captured = self.graphs.get(key)
        if captured is None:
            if key not in self.seen:  # the signature's first call: eager, the warm-up
                self.seen[key] = None
                if len(self.seen) > SEEN_SIGNATURES:
                    self.seen.popitem(last=False)
                return tuple(body(*inputs))
            while len(self.graphs) >= self.size:
                self.graphs.popitem(last=False)
            if self.shared_pool and self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            captured = CapturedGraph(body, inputs, self.pool, generators, after)
            self.graphs[key] = captured
            self.captures += 1
        self.graphs.move_to_end(key)
        return captured.replay(inputs)
