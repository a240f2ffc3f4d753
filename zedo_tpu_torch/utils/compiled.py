"""Compiled step loops: the port's counterpart of `jax.jit` over a `lax.scan`.

The solve's loops (IPO's Adam steps, OIL's steps) are written as scan bodies.
A scan body is one step,

    body(carry, consts, ys, counter, generator, variant) -> carry

a `functools.partial` of a module-level function whose keywords are the
static arguments (configs, the SDE, the sampler, `model_apply`: hashable).
It reads its per-step inputs (JAX's `xs`) from the device tables in `consts`
at the device step counter `counter` ([1] int64, e.g. `index_select`), and
writes its per-step outputs into the tables of `ys` at the same counter
(`index_copy_`). It may update carry tensors in place and return them. Its
noise comes from `generator`. No Python value that changes from step to step
reaches it except `variant`: the host's choice among a few bodies (OIL:
re-solve the translation or not, evaluate the model or reuse its output),
where JAX's scan takes a boolean `xs` into `jnp.where` or `lax.cond`.

`scan(..., compiled=False)` runs the body in a Python loop: the eager oracle.
`scan(..., compiled=True)` builds, once per key, an entry holding static
copies of the carry, consts and ys. On CUDA tensors each variant is then run
a few steps on a side stream with scratch copies of the carry and ys (the
warm-up: autograd's and cuBLAS's lazy set-up, the kernels' libraries and
their cached tensor maps), captured once as a CUDA graph with the copy of its
result into the static carry and the counter's increment, and replayed once a
step. The entries are cached as jit caches its programs: the key is the
body's function and static arguments, the schedule of variants, the tree
structure and every tensor's shape, stride, dtype and device. A call copies
its tensors into the static buffers (new values of the same shapes capture
nothing anew), replays, and returns clones. On CPU tensors the entry runs the
same step function eagerly on its static buffers: the caller asked for the
CPU. On CUDA a failure to capture or replay raises; nothing falls back to the
eager loop.

A generator's draws stay the eager loop's: the entry draws from a generator
of its own, registered with every graph, whose state is set from the
caller's before the replays and copied back after them, so the caller's
generator stands where the eager loop leaves it.

Kernel wrappers count their launches in dicts registered here
(`register_counters`). The counters' increase during a capture is recorded
and added again on each replay; neither the warm-up nor the capture counts.
`cache_info()` also counts the CUDA graphs captured and the seconds spent
in warm-ups and captures (the span `zedo.capture`, on the host clock up to
the last capture's end; each capture begins with a device synchronize, so
the warm-up's device work is inside): a process's totals, which
`clear_cache()` keeps. Nothing is timed or counted a replay.

`step(...)` is one compiled call of a function that is not a loop (JAX's
`jax.jit` of a plain function): a scan of length 1. Given no carry, the
body's return value is the call's result: the graph's own output tensors
after its capture, returned as clones. With `donate=True` the
carry's own tensors are the static buffers (JAX's `donate_argnums`): the
body updates them in place, a call copies nothing in or out of them, and the
key holds their addresses, so other tensors of the same shapes capture anew.
The warm-up then runs on the carry itself and puts its values back after.
The entry holds the carry only during a call: once a tensor of it is
collected, the entry leaves the cache, its graphs and buffers with it (a
state the caller drops frees the card's memory it held). The train step
donates its state this way (params, Adam's moments and step counts, the
EMA's shadows and count).

`while_loop(cond, body, ...)` is `lax.while_loop`: the body runs masked by
`cond` (a step where `cond` is false changes nothing, `torch.where`), the
host replays a graph of `chunk` masked steps and reads `cond` once per chunk
(one device-to-host read), and the eager oracle runs the same masked steps
and reads `cond` at the same chunk boundaries, so both run the same steps.
(CUDA's conditional while-nodes would keep the read on the device;
`torch.cuda.CUDAGraph` exposes no conditional node, so the loop is chunked.)

An entry's buffers serve one call at a time: calls from several threads of
one process must not overlap.
"""
from __future__ import annotations

import collections
import functools
import time
import weakref
from typing import Optional

import torch

from zedo_tpu_torch.utils import profiling

# steps each variant runs on scratch copies before its capture
WARMUP_STEPS = 3
# compiled scans kept; the least recently used goes first
MAX_ENTRIES = 32

_COUNTERS: list = []
_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_STATS = {"hits": 0, "misses": 0, "captures": 0, "capture_s": 0.0}
_READS = {"host_reads": 0}
_TENSOR = "tensor"


def register_counters(*counters: dict) -> None:
    """Launch counters (name -> count) that a kernel wrapper adds one to per
    launch: each replay of a graph adds what its capture added."""
    _COUNTERS.extend(counters)


def cache_info() -> dict:
    """Hits, misses and entries of the cache of compiled scans since it was
    last cleared, and the graphs captured and seconds of warm-up and capture
    since the process began."""
    return {**_STATS, "entries": len(_CACHE)}


def host_reads() -> int:
    """The while loops' reads of their condition to the host so far, eager
    and compiled (one a chunk)."""
    return _READS["host_reads"]


def clear_cache() -> None:
    _CACHE.clear()
    _STATS.update(hits=0, misses=0)


def _flatten(tree):
    """(tensor leaves, hashable spec of everything else) of a tree of dicts,
    tuples, lists and NamedTuples; any other leaf is static, in the spec."""
    if isinstance(tree, torch.Tensor):
        return [tree], _TENSOR
    if isinstance(tree, dict):
        parts = [(k, _flatten(v)) for k, v in tree.items()]
        return ([t for _, (ls, _) in parts for t in ls],
                (dict, tuple((k, spec) for k, (_, spec) in parts)))
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        return [t for ls, _ in parts for t in ls], (type(tree), tuple(s for _, s in parts))
    return [], ("static", tree)


def _unflatten(spec, leaves):
    if spec == _TENSOR:
        return next(leaves)
    kind, parts = spec
    if kind == "static":
        return parts
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in parts}
    items = [_unflatten(s, leaves) for s in parts]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def _leaves(tree) -> list:
    return _flatten(tree)[0]


def _signature(tree) -> tuple:
    leaves, spec = _flatten(tree)
    return spec, tuple((tuple(t.shape), t.stride(), t.dtype, str(t.device)) for t in leaves)


def _map(fn, tree):
    leaves, spec = _flatten(tree)
    return _unflatten(spec, iter([fn(t) for t in leaves]))


def _clone(tree):
    return _map(lambda t: t.detach().clone(), tree)


def _pairs(dst, src):
    """(dst leaf, src leaf) of two trees of one structure, by key."""
    if isinstance(dst, torch.Tensor):
        yield dst, src
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"tree keys {sorted(src)} where {sorted(dst)} were captured")
        for k in dst:
            yield from _pairs(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src, strict=True):
            yield from _pairs(d, s)


def _copy_into(dst, src) -> None:
    with torch.no_grad():
        for d, s in _pairs(dst, src):
            if d is not s:
                d.copy_(s)


def _device(*trees) -> torch.device:
    for tree in trees:
        leaves = _leaves(tree)
        if leaves:
            return leaves[0].device
    raise ValueError("a scan needs at least one tensor")


def _snapshot() -> list:
    return [dict(c) for c in _COUNTERS]


def _restore(snapshot) -> None:
    for counter, saved in zip(_COUNTERS, snapshot):
        counter.clear()
        counter.update(saved)


def _increase(snapshot) -> list:
    return [{k: v - saved.get(k, 0) for k, v in counter.items() if v != saved.get(k, 0)}
            for counter, saved in zip(_COUNTERS, snapshot)]


def _add(increase) -> None:
    for counter, inc in zip(_COUNTERS, increase):
        for k, v in inc.items():
            counter[k] = counter.get(k, 0) + v


def _eager(body, schedule, carry, consts, ys, generator):
    counter = torch.zeros(1, dtype=torch.int64, device=_device(carry, consts, ys))
    for variant in schedule:
        carry = body(carry, consts, ys, counter, generator, variant)
        counter.add_(1)
    return carry, ys


def _read(flag: torch.Tensor) -> bool:
    """A while loop's condition on the host: its one read a chunk."""
    _READS["host_reads"] += 1
    return bool(flag.item())


class _Entry:
    """The static buffers of one compiled scan and, on CUDA, one graph per
    variant of its body. chunk: steps a graph runs; cond: a while loop's
    condition, written after them into `flag`."""

    def __init__(self, body, variants, carry, consts, ys, generator, donate=False, chunk=1,
                 cond=None):
        self.body, self.donate, self.chunk, self.cond = body, donate, chunk, cond
        # no carry: the body's result is the output (kept where it was made)
        self.produce = carry is None
        self.carry = carry if donate or self.produce else _clone(carry)
        self.consts, self.ys = _clone(consts), _clone(ys)
        self.device = _device(carry, consts, ys)
        self.counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.flag = torch.zeros(1, dtype=torch.bool, device=self.device)
        self.generator = (None if generator is None
                          else torch.Generator(device=self.device))
        self.graphs, self.launches = {}, {}
        if self.device.type == "cuda" and variants:
            self._capture(variants)
        if donate:
            self.carry = None  # the caller's: held only during a call

    def _step(self, variant) -> None:
        """`chunk` steps on the static buffers (and the condition after them):
        the function that is captured."""
        for _ in range(self.chunk):
            new = self.body({} if self.produce else self.carry, self.consts, self.ys,
                            self.counter, self.generator, variant)
            if self.produce:
                self.carry = new
            else:
                _copy_into(self.carry, new)
            self.counter.add_(1)
        if self.cond is not None:
            self.flag.copy_(self.cond(self.carry, self.consts).reshape(1))

    def _warm_up(self, variants) -> None:
        """WARMUP_STEPS steps of each variant on scratch copies of the carry
        and ys (a donated carry: on itself, its values put back after)."""
        saved = _clone(self.carry) if self.donate else None
        try:
            for variant in variants:
                carry = (self.carry if self.donate
                         else {} if self.produce else _clone(self.carry))
                ys = _clone(self.ys)
                counter = torch.zeros_like(self.counter)
                for _ in range(WARMUP_STEPS):
                    new = self.body(carry, self.consts, ys, counter, self.generator, variant)
                    if self.donate:
                        _copy_into(carry, new)
                    elif not self.produce:
                        carry = new
                if self.cond is not None:
                    self.cond(carry, self.consts)
        finally:
            if saved is not None:
                _copy_into(self.carry, saved)

    def _capture(self, variants) -> None:
        dev = self.device
        saved = _snapshot()
        start = time.perf_counter()
        try:
            with profiling.annotate("zedo.capture"):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self._warm_up(variants)
                torch.cuda.current_stream(dev).wait_stream(side)
                _restore(saved)
                pool = None
                for variant in variants:
                    graph = torch.cuda.CUDAGraph()
                    if self.generator is not None:
                        graph.register_generator_state(self.generator)
                    # begins with a device synchronize
                    with torch.cuda.graph(graph, pool=pool):
                        self._step(variant)
                    self.launches[variant] = _increase(saved)
                    _restore(saved)
                    pool = graph.pool()
                    self.graphs[variant] = graph
                    _STATS["captures"] += 1
        finally:
            _restore(saved)
            _STATS["capture_s"] += time.perf_counter() - start

    def _load(self, carry, consts, ys, generator) -> None:
        _copy_into(self.consts, consts)
        if self.donate:
            self.carry = carry
        elif not self.produce:
            _copy_into(self.carry, carry)
        _copy_into(self.ys, ys)
        self.counter.zero_()
        if self.generator is not None:
            self.generator.set_state(generator.get_state())

    def _play(self, schedule) -> None:
        """Each step of `schedule`: its variant's graph replayed and its
        launches counted, or on the CPU the step itself. The device test
        stays outside the loop, which runs once a step of every solve."""
        if self.device.type == "cuda":
            for variant in schedule:
                self.graphs[variant].replay()
                _add(self.launches[variant])
        else:
            for variant in schedule:
                self._step(variant)

    def _result(self, generator):
        if self.generator is not None:
            generator.set_state(self.generator.get_state())
        if self.donate:
            carry, self.carry = self.carry, None
        else:
            carry = _clone(self.carry)
        return carry, _clone(self.ys)

    def run(self, schedule, carry, consts, ys, generator):
        self._load(carry, consts, ys, generator)
        self._play(schedule)
        return self._result(generator)

    def run_while(self, carry, consts, generator):
        """Chunks until the condition read after one is false."""
        self._load(carry, consts, {}, generator)
        self._play((None,))
        while _read(self.flag):
            self._play((None,))
        return self._result(generator)[0]


def _static(value):
    """A hashable form of a static argument: a functools.partial by its
    function and arguments, so that a fresh partial of the same function and
    arguments (a guidance objective built anew per call) is the same
    program."""
    if isinstance(value, functools.partial):
        return (functools.partial, value.func, tuple(_static(a) for a in value.args),
                tuple(sorted((k, _static(v)) for k, v in value.keywords.items())))
    return value


def _key(body, schedule, carry, consts, ys, generator, donate=False) -> tuple:
    if not isinstance(body, functools.partial) or body.args:
        raise TypeError("a compiled scan body is a functools.partial of a function with "
                        "keyword (static) arguments only")
    static = tuple(sorted((k, _static(v)) for k, v in body.keywords.items()))
    # a donated carry's tensors are the graphs' own buffers
    owner = tuple(t.data_ptr() for t in _leaves(carry)) if donate else None
    return (body.func, static, schedule, _signature(carry), _signature(consts),
            _signature(ys), generator is not None, owner)


def _forget(key, ref) -> None:
    """Drop the entry of `ref` (a donated carry's tensor was collected)."""
    entry = ref()
    if entry is not None and _CACHE.get(key) is entry:
        del _CACHE[key]


def _entry(key, make, donated=None) -> _Entry:
    """The cached entry of `key`, made if missing; donated: the carry whose
    tensors its graphs are bound to, the entry dropped when one is
    collected."""
    entry = _CACHE.get(key)
    if entry is None:
        _STATS["misses"] += 1
        entry = make()
        _CACHE[key] = entry
        for leaf in _leaves(donated):
            weakref.finalize(leaf, _forget, key, weakref.ref(entry))
        while len(_CACHE) > MAX_ENTRIES:
            _CACHE.popitem(last=False)
    else:
        _STATS["hits"] += 1
        _CACHE.move_to_end(key)
    return entry


def scan(body, schedule, carry: dict, consts: dict, ys: dict, generator=None,
         compiled: bool = False, donate: bool = False):
    """Run `body` once for each entry of `schedule` (a tuple: the variant of
    each step, in order) from `carry`; returns (carry, ys). `ys`: the tables
    the body writes per step (in place when eager, copies when compiled).
    compiled=False: the eager loop. compiled=True: the cached compiled scan
    (CUDA graphs on CUDA tensors; see the module docstring). donate: the
    carry's tensors are the compiled scan's buffers, updated in place and
    returned."""
    schedule = tuple(schedule)
    if not compiled:
        return _eager(body, schedule, carry, consts, ys, generator)
    key = _key(body, schedule, carry, consts, ys, generator, donate)
    entry = _entry(key, lambda: _Entry(body, tuple(dict.fromkeys(schedule)), carry, consts, ys,
                                       generator, donate=donate), carry if donate else None)
    return entry.run(schedule, carry, consts, ys, generator)


def step(body, carry: Optional[dict], consts: dict, ys: Optional[dict] = None, generator=None,
         compiled: bool = False, donate: bool = False):
    """One call of `body` (a scan body; its variant is None, its counter 0):
    JAX's `jax.jit` of a function that is not a loop. Returns (carry, ys);
    carry None: the body is given an empty carry and its result is the
    returned carry."""
    ys = {} if ys is None else ys
    if carry is None and not compiled:
        return _eager(body, (None,), {}, consts, ys, generator)
    return scan(body, (None,), carry, consts, ys, generator, compiled=compiled, donate=donate)


def _masked_body(carry, consts, ys, counter, generator, variant, *, body, cond):
    """`body` where `cond` holds; elsewhere the carry unchanged."""
    go = cond(carry, consts).reshape(())
    new = body(carry, consts, ys, counter, generator, variant)
    old_leaves, spec = _flatten(carry)
    new_leaves = _leaves(new)
    return _unflatten(spec, iter([torch.where(go, n, o)
                                  for n, o in zip(new_leaves, old_leaves, strict=True)]))


def while_loop(cond, body, carry: dict, consts: dict, generator=None, chunk: int = 8,
               compiled: bool = False) -> dict:
    """`lax.while_loop(cond, body, carry)`: cond(carry, consts) -> a bool
    device tensor of one element; body a scan body (its variant None).
    Masked steps run in chunks of `chunk`, the condition read to the host
    after each (see the module docstring); returns the final carry."""
    if chunk < 1:
        raise ValueError(f"chunk {chunk}: a while loop runs at least one step a chunk")
    masked = functools.partial(_masked_body, body=body, cond=cond)
    if not compiled:
        counter = torch.zeros(1, dtype=torch.int64, device=_device(carry, consts))
        while True:
            for _ in range(chunk):
                carry = masked(carry, consts, {}, counter, generator, None)
                counter.add_(1)
            if not _read(cond(carry, consts)):
                return carry
    key = ("while", chunk) + _key(masked, (None,), carry, consts, {}, generator)
    entry = _entry(key, lambda: _Entry(masked, (None,), carry, consts, {}, generator,
                                       chunk=chunk, cond=cond))
    return entry.run_while(carry, consts, generator)
