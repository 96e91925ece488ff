"""The AR decode loop on the device (port of the JAX package's
`lax.while_loop` at xtts_tpu/infer/qdecode.py:624 and
xtts_tpu/models/gpt_infer.py:136, bounded as xtts_tpu/infer/slots.py:195-209
bounds its loop).

The loop's carry lives in tensors on the model's device (`LoopState`):
step, logits, done, seen, codes, lengths, the prefix length, the mel
position offset and the rung's capacity; the KV cache beside it. One
`decode_step` samples, masks, writes codes / seen / lengths at the device
step, embeds at the device mel position and runs the engine's step at the
device cache index, all in place and with no read back to the host. A step
after every row is done, or at step == cap, leaves step, codes, lengths,
seen and logits as they are (slots.py:178-192), so steps and codes equal
the JAX loop's whatever the number of steps run between two host reads.

On a CUDA model, `generate` captures CHUNK such steps into one
`torch.cuda.CUDAGraph` and replays it, reading `(step, all done)` once a
replay: one host round trip per CHUNK tokens instead of one a token. On the
CPU (or inside `eager()`) the same steps run eagerly, CHUNK between two
reads. Graphs are kept per set of weights, keyed on the engine, the rows,
the cache's length (rounded up to S_BUCKET, so prompts of other lengths
share a capture), max_gen and the sampling settings; they read static
buffers that each request refills. Each set of weights keeps at most
MAX_STATES loop states, MAX_CACHES caches and MAX_GRAPHS graphs, the least
recently used going first (with the graphs that read it); its graphs share
one memory pool. The first chunk of a key runs eagerly (it warms up what a
capture cannot create: the gemv scratch, the shared memory opt-ins,
cuBLAS); capture failures raise. A graph holds the gemv scratch's address
of its capture: when the scratch grows (ops/decode_step.py
gemv_scratch_epoch), every graph captured before is dropped. A rung with
fewer than
CHUNK steps left runs them eagerly, so no masked step draws a number that
a later rung's tokens would have used; after the last live step the
generator is set back to where that step left it, so whatever follows
(the diffusion noise) draws the same numbers for any CHUNK.

Sampling draws from the caller's generator; a replay draws from a
generator registered with the graph, seeded and offset from the caller's
before and copied back after. Kernel launch counts (`fn.launches` of
ops/decode_step.py and ops/serving_step.py) count what ran: a capture's
counts are taken back and added once a replay.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from xtts_tpu_torch.infer.sampling import greedy_token, sample_token
from xtts_tpu_torch.ops import decode_step as _ds
from xtts_tpu_torch.ops import serving_step as _ss

CHUNK = 16        # steps a CUDA graph holds: one host read per CHUNK tokens
S_BUCKET = 128    # cache positions are rounded up to a multiple of this
MAX_STATES = 8    # loop states, caches and graphs kept per set of weights
MAX_CACHES = 8
MAX_GRAPHS = 32


class GenerateResult(NamedTuple):
    codes: torch.Tensor    # (B, max_gen) int64, stop-padded
    lengths: torch.Tensor  # (B,) generated tokens incl. the stop token
    steps: int             # decode iterations executed


class Sampling(NamedTuple):
    do_sample: bool
    temperature: float
    top_p: float
    repetition_penalty: float


class Engine(NamedTuple):
    """One decode engine as the loop drives it: `make(cache)` returns
    step(tok (B,), mel_pos (0-d), index (0-d)) -> logits (B, V), which
    updates the cache tensors in place; `s_axis` is their position axis;
    `anchor` a tensor (or module) of the weights the step reads, which keys
    its graphs."""
    name: str
    anchor: Any
    s_axis: int
    make: Callable[[Tuple[torch.Tensor, ...]], Callable]


class LoopStats:
    """What the loops did since reset(): host reads of the loop state, CUDA
    graph replays, steps run eagerly, captures and their host time."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.syncs = self.replays = self.eager_steps = self.captures = 0
        self.capture_ms = 0.0


STATS = LoopStats()


class LoopState:
    """The while_loop's carry on the device; decode_step writes it in
    place, so a captured graph reads and writes the same buffers."""

    def __init__(self, b: int, vocab: int, max_gen: int, dtype, device):
        def scalar():
            return torch.zeros((), dtype=torch.long, device=device)
        self.step, self.p_len, self.pos_off, self.cap = (scalar(), scalar(),
                                                         scalar(), scalar())
        self.logits = torch.zeros((b, vocab), dtype=dtype, device=device)
        self.done = torch.zeros((b,), dtype=torch.bool, device=device)
        self.seen = torch.zeros((b, vocab), dtype=torch.bool, device=device)
        self.codes = torch.zeros((b, max_gen), dtype=torch.long,
                                 device=device)
        self.lengths = torch.zeros((b,), dtype=torch.long, device=device)

    def reset(self, logits, p_len: int, pos_off: int, stop: int,
              start_token: int) -> None:
        """The loop's initial carry: the prefill's logits; ids HF's
        repetition penalty has already seen (the fake input id 1 and the
        start mel token)."""
        self.step.zero_()
        self.p_len.fill_(p_len)
        self.pos_off.fill_(pos_off)
        self.logits.copy_(logits)
        self.done.zero_()
        self.seen.zero_()
        self.seen[:, 1] = True
        self.seen[:, start_token] = True
        self.codes.fill_(stop)
        self.lengths.zero_()


def decode_step(st: LoopState, engine_step, sampling: Sampling, stop: int,
                pos_rows: int, generator) -> None:
    """One iteration of the JAX loop body on the device, masked where the
    JAX loop would not run it (every row done, or step == cap): sample ->
    stop-mask -> codes / seen / lengths / done at `step` -> the engine's
    step at mel position step + pos_off and cache index p_len + step.
    No host read: the index and the positions stay tensors."""
    live = (st.step < st.cap) & ~st.done.all()
    if sampling.do_sample:
        tok = sample_token(generator, st.logits,
                           temperature=sampling.temperature,
                           top_p=sampling.top_p, seen=st.seen,
                           repetition_penalty=sampling.repetition_penalty)
    else:
        tok = greedy_token(st.logits)
    tok = tok.masked_fill(st.done, stop)
    # a masked step at step == cap == max_gen rewrites the last column with
    # itself
    col = st.step.clamp(max=st.codes.shape[1] - 1).reshape(1)
    kept = st.codes.index_select(1, col)[:, 0]
    st.codes.index_copy_(1, col, torch.where(live, tok, kept)[:, None])
    hit = tok[:, None]
    st.seen.scatter_(1, hit, st.seen.gather(1, hit) | live)
    st.lengths.copy_(torch.where(st.done | ~live, st.lengths, st.step + 1))
    st.done.copy_(st.done | (live & (tok == stop)))
    # code t sits at mel position pos_off + t (the reference quirk adds
    # n_cond); a masked step past the table reads its last row
    mel_pos = (st.step + st.pos_off).clamp(max=pos_rows - 1)
    logits = engine_step(tok, mel_pos, st.p_len + st.step)
    st.logits.copy_(torch.where(live, logits, st.logits))
    st.step.add_(live.long())


def cache_rows(p_len: int, cap: int) -> int:
    """A rung's cache length: the prefix, cap tokens and the row a masked
    step at step == cap writes, rounded up to S_BUCKET (the zero padding
    is exact: no step reads a position it has not written). This is the
    range check of the indices p_len + step, step <= cap, that the rung
    passes to the kernels unchecked."""
    return -(-(p_len + cap + 1) // S_BUCKET) * S_BUCKET


def _zeros(cache, s_axis: int, rows: int):
    """Zero buffers shaped as `cache` with `rows` positions."""
    out = []
    for t in cache:
        shape = list(t.shape)
        shape[s_axis] = rows
        out.append(t.new_zeros(shape))
    return tuple(out)


def _grow(cache, s_axis: int, into):
    """`cache` copied into the zeroed buffers `into` (more positions)."""
    for t, n in zip(cache, into):
        n.zero_().narrow(s_axis, 0, t.shape[s_axis]).copy_(t)
    return into


def _counters():
    fns = (_ds.KERNELS + (_ds.fused_decode_logits,) + _ss.KERNELS
           + (_ss.fused_serving_logits,))
    return [(fn, a) for fn in fns for a in ("launches", "ln_launches")
            if hasattr(fn, a)]


def _read_counts():
    return [getattr(fn, a) for fn, a in _counters()]


def _add_counts(delta) -> None:
    for (fn, a), n in zip(_counters(), delta):
        setattr(fn, a, getattr(fn, a) + n)


class _Graph(NamedTuple):
    graph: Any
    generator: Optional[torch.Generator]
    launches: list        # the launch counts one replay adds


class Store:
    """The static buffers and graphs of one set of weights, each an LRU.
    A graph's key is (cache key, rows, state key, sampling, chunk): it
    reads that cache and that state, and goes with either."""

    def __init__(self):
        self.lock = threading.Lock()
        self.states: "OrderedDict[tuple, LoopState]" = OrderedDict()
        self.caches: "OrderedDict[tuple, Tuple[torch.Tensor, ...]]" = \
            OrderedDict()
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.warm: set = set()
        self.pool = None
        self.epoch = None

    def _drop(self, gone: Callable[[tuple], bool]) -> None:
        """Forget every graph (and warm mark) whose key `gone` holds."""
        for key in [k for k in self.graphs if gone(k)]:
            del self.graphs[key]
        self.warm = {k for k in self.warm if not gone(k)}

    def _lru(self, table: OrderedDict, key, make, cap: int, gone) -> Any:
        got = table.get(key)
        if got is None:
            got = table[key] = make()
            while len(table) > cap:
                old = table.popitem(last=False)[0]
                self._drop(lambda k: gone(k, old))
        table.move_to_end(key)
        return got

    def state(self, key, make) -> "LoopState":
        return self._lru(self.states, key, make, MAX_STATES,
                         lambda k, old: k[2] == old)

    def cache(self, key, make) -> Tuple[torch.Tensor, ...]:
        return self._lru(self.caches, key, make, MAX_CACHES,
                         lambda k, old: k[:2] == old)

    def graph(self, key, make) -> "_Graph":
        return self._lru(self.graphs, key, make, MAX_GRAPHS,
                         lambda k, old: False)

    def check_scratch(self) -> None:
        """Drop every graph if the gemv scratch grew since their capture
        (they hold the freed partials' address)."""
        now = _ds.gemv_scratch_epoch()
        if self.epoch != now:
            self._drop(lambda k: True)
            self.epoch = now


_STORES: Dict[int, Tuple[Any, Store]] = {}


def _store(anchor) -> Store:
    """The anchor's store; dropped when the anchor is freed."""
    got = _STORES.get(id(anchor))
    if got is not None and got[0]() is anchor:
        return got[1]
    store = Store()
    _STORES[id(anchor)] = (weakref.ref(anchor), store)
    weakref.finalize(anchor, _STORES.pop, id(anchor), None)
    return store


def _default_generator(device) -> torch.Generator:
    if device.type == "cuda":
        i = device.index if device.index is not None else \
            torch.cuda.current_device()
        return torch.cuda.default_generators[i]
    return torch.default_generator


_EAGER = 0


def graphed(device) -> bool:
    """Whether steps on `device` run as CUDA graphs: on a CUDA device,
    outside `eager()`."""
    return device.type == "cuda" and not _EAGER


@contextlib.contextmanager
def eager():
    """Inside it, `generate` runs its chunks eagerly on a CUDA device too:
    the comparator of the graphs (same steps, same reads)."""
    global _EAGER
    _EAGER += 1
    try:
        yield
    finally:
        _EAGER -= 1


def _capture(run, chunk: int, do_sample: bool, store: Store,
             device) -> _Graph:
    """CHUNK steps of `run` captured into one CUDA graph in the store's
    memory pool (its graphs never run at once, and each leaves nothing
    alive in the pool); raises if the capture fails. The capture's launch
    counts are taken back."""
    gen = torch.Generator(device=device) if do_sample else None
    graph = torch.cuda.CUDAGraph()
    if gen is not None:
        graph.register_generator_state(gen)
    if store.pool is None:
        store.pool = torch.cuda.graph_pool_handle()
    before, epoch = _read_counts(), _ds.gemv_scratch_epoch()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, pool=store.pool,
                          capture_error_mode="thread_local"):
        for _ in range(chunk):
            run(gen)
    torch.cuda.synchronize(device)
    if _ds.gemv_scratch_epoch() != epoch:
        raise RuntimeError("the gemv scratch grew inside a capture: its "
                           "shapes were not warmed up")
    STATS.capture_ms += (time.perf_counter() - t0) * 1e3
    STATS.captures += 1
    after = _read_counts()
    _add_counts([b - a for a, b in zip(after, before)])
    return _Graph(graph, gen, [a - b for a, b in zip(after, before)])


def _replay(g: _Graph, generator) -> None:
    if g.generator is not None:
        g.generator.manual_seed(generator.initial_seed())
        g.generator.set_offset(generator.get_offset())
    g.graph.replay()
    if g.generator is not None:
        generator.set_offset(g.generator.get_offset())
    _add_counts(g.launches)
    STATS.replays += 1


def run_chunk(store: Optional[Store], key, run, k: int, chunk: int,
              do_sample: bool, device,
              generator: Optional[torch.Generator] = None) -> None:
    """k steps of `run` (one step: run(generator)), the chunk policy of
    every graphed loop: with a store (see `graphed`), a full chunk of a
    warm key replays its graph, captured on first use; otherwise the steps
    run eagerly, and a full eager chunk marks its key warm, so the next
    one is captured (the first chunk warms up what a capture cannot
    create). Graphs drop first when the gemv scratch has grown."""
    if store is not None:
        store.check_scratch()
        if k == chunk and key in store.warm:
            g = store.graph(key, functools.partial(
                _capture, run, chunk, do_sample, store, device))
            _replay(g, generator)
            return
    for _ in range(k):
        run(generator)
    STATS.eager_steps += k
    if store is not None and k == chunk:
        store.warm.add(key)


@torch.no_grad()
def generate(engine: Engine, prefix_cache: Tuple[torch.Tensor, ...],
             logits: torch.Tensor, *, p_len: int, pos_off: int,
             pos_rows: int, caps: tuple, stop: int, start_token: int,
             sampling: Sampling, generator: Optional[torch.Generator] = None
             ) -> GenerateResult:
    """Run the AR loop from the prefill's cache (the prefix's p_len
    positions, in the engine's layout) and logits (B, V) through the
    ladder `caps` (ladder_caps), CHUNK steps between two host reads,
    replayed as CUDA graphs on a CUDA device unless inside `eager()`."""
    chunk = CHUNK
    dev = logits.device
    graphs = graphed(dev)
    gen = generator if generator is not None else _default_generator(dev)
    b, vocab = logits.shape
    max_gen = caps[-1]
    store = _store(engine.anchor) if graphs else None
    with store.lock if store else contextlib.nullcontext():
        skey = (b, vocab, max_gen, logits.dtype)
        new_state = functools.partial(LoopState, b, vocab, max_gen,
                                      logits.dtype, dev)
        st = new_state() if store is None else store.state(skey, new_state)
        st.reset(logits, p_len, pos_off, stop, start_token)
        cache, step, done = prefix_cache, 0, False
        for cap in caps:
            if done:
                break
            rows = cache_rows(p_len, cap)
            ckey = (engine.name,) + tuple(
                (tuple(t.shape[:engine.s_axis]), tuple(
                    t.shape[engine.s_axis + 1:]), t.dtype) for t in cache)
            if cache[0].shape[engine.s_axis] < rows:   # not the same bucket
                new_cache = functools.partial(_zeros, cache, engine.s_axis,
                                              rows)
                into = (new_cache() if store is None
                        else store.cache((ckey, rows), new_cache))
                cache = _grow(cache, engine.s_axis, into)
            st.cap.fill_(cap)
            run = functools.partial(decode_step, st, engine.make(cache),
                                    sampling, stop, pos_rows)
            gkey = (ckey, rows, skey, sampling, chunk)
            while step < cap and not done:
                k = min(chunk, cap - step)
                mark = (gen.get_offset() if sampling.do_sample
                        and gen.device.type == "cuda" else None)
                snaps = []

                def one(g, run=run, snaps=snaps,   # a CPU generator's
                        keep=sampling.do_sample and mark is None):  # states
                    if keep:
                        snaps.append(g.get_state())
                    run(g)
                run_chunk(store, gkey, one, k, chunk, sampling.do_sample,
                          dev, gen)
                now, all_done = torch.stack(
                    [st.step, st.done.all().long()]).tolist()
                STATS.syncs += 1
                live, step, done = now - step, now, bool(all_done)
                if sampling.do_sample and live < k:
                    # the chunk's masked steps drew numbers the JAX loop
                    # never draws: back to where the last live step left off
                    if mark is not None:
                        per_step = (gen.get_offset() - mark) // k
                        gen.set_offset(mark + live * per_step)
                    else:
                        gen.set_state(snaps[live])
        return GenerateResult(st.codes.clone(), st.lengths.clone(), step)
