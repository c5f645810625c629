"""The multi-step training window on the card: one train step captured as a
CUDA graph and replayed once per step.

The reference runs `steps_per_call` steps in one device program (`lax.scan`
over the train step, the timestep's camera data on the device, each step's
batch gathered by index), so the host touches nothing inside a window. On a
GPU the counterpart is a CUDA graph of the step. `StepWindow` keeps static
buffers -- the parameters, Adam state and variables, the learning rates, the
timestep's stacked camera data, the window's camera indices and a device
step counter -- and captures one step on them: the step's batch gathered by
the counter, `make_train_step`'s step with the emission and the record
table at a fixed pair capacity (E1 writes at most that many live pairs and
counts the rest on the device; `sorted_raster.prepare_records_static`; no
host read), the new
state copied back into the static buffers, the step's metrics into a row of
a history table, the counter advanced. A window of W steps is then:

  1. the caller's state, learning rates, data and camera indices copied in;
  2. the first step of the first window run eagerly with the eager record
     table (`prepare_records`, whose host read of the live-pair count sets
     the capacity);
  3. when no graph of these shapes and constants exists (a first window, a
     new capacity, K or table size, `is_initial`, more or other variables):
     one step run eagerly on a side stream (the warm-up), then one captured
     (the learning rates and the data are inputs, copied in at step 1, so
     the rates frozen after t = 0 and a new timestep's images need none);
  4. the graph replayed for the window's remaining steps;
  5. one host read at the end: each step's live pairs and overflow.

The capacity rule: the largest live count seen, times HEADROOM, rounded up
(`pair_capacity`). A window in which any step had live pairs past the
capacity is discarded -- the caller's tensors are its start state, which the
window only copied -- the capacity grows, the step is captured again and the
window runs again (a redo, counted in `stats`). A capacity more than
SHRINK times what the last window needed shrinks at the next window. A new
train step (`set_step`, after a K escalation) keeps the capacity and is
captured at the next window. So a window's result is always the eager
steps' result: with the capacity at or above the live count the static
table is bitwise the eager one.

K1's and K2's wrappers count a captured launch once on the host; the
kernels' device counters count every run, replays included
(`ops/cuda/launches.py`). A failed capture, or a host read inside it,
raises; nothing falls back to eager steps.

With tracing on (`utils/logging.py::set_tracing`) the host's work is in
spans: `window.load` (the copy-in), `window.eager` (the warm-up and eager
steps), `window.capture`, `window.replay` (one per graph launch),
`window.read` (the one host read) and `window.result` (the clones); the
captured step holds the train step's phase marks, which replay with it.
The setting is part of the graph's key, so turning it on or off captures
the step again at the next window.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from dynamic3dgaussians_tpu_torch.ops.camera import Camera, select_camera
from dynamic3dgaussians_tpu_torch.train import optim
from dynamic3dgaussians_tpu_torch.utils.logging import span, tracing

HEADROOM = 1.25     # capacity over the largest live count seen
SHRINK = 2.0        # shrink once the capacity is this many times the need
GROW = 1.5          # a redo's capacity is at least this times the last
SUMMED = ("n_dropped", "n_dropped_rect")   # summed over a window
PAIR_KEYS = ("n_live_pairs", "n_pair_overflow")
CAMERA_STATIC = ("height", "width", "near", "far")


def pair_capacity(n_live: int, n_slots: int) -> int:
    """n_live * HEADROOM rounded up to a multiple of 1/16 of its next power
    of two (less than an eighth more) and of 1,024, at most the n_slots =
    K * N emission slots (no more pairs can be live). The coarse steps keep
    a drifting live count from changing the capacity, and with it the
    captured graph, every window. A K escalation keeps it: a step whose
    live pairs then outgrow it is redone at a larger one."""
    want = max(1, int(n_live * HEADROOM + 0.999))
    grain = max(1024, 1 << max(want.bit_length() - 4, 0))
    return max(1, min(n_slots, -(-want // grain) * grain))


def window_metrics(metrics: List[Dict]) -> Dict:
    """A window's metrics from its steps': the last step's values, except
    `SUMMED`, summed (the K escalation must see a drop on any step)."""
    out = dict(metrics[-1])
    for k in SUMMED:
        if k in out:
            out[k] = torch.stack([m[k] for m in metrics]).sum().to(
                out[k].dtype)
    return out


def batch_at(data_stack: Dict, row: torch.Tensor):
    """The step batch of camera indices `row` ((k,) int64 on the data's
    device) from `stack_timestep_data`'s stack: one datapoint dict for k ==
    1 given as a 0-d index, else a list of k dicts. Gathers only: no host
    read."""
    def one(idx):
        out = {}
        for key, v in data_stack.items():
            if isinstance(v, Camera):
                out[key] = select_camera(v, idx)
            else:
                out[key] = v.index_select(0, idx)[0]
        return out
    if row.dim() == 0:
        return one(row.reshape(1))
    return [one(row[j:j + 1]) for j in range(row.shape[0])]


class CudaGraph:
    """A `torch.cuda.CUDAGraph` behind capture(fn) / replay(). The capture
    is thread-local: a host read on this thread raises, another thread's
    work (a data loader's copies) is left alone."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable[[], None]) -> None:
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            fn()

    def replay(self) -> None:
        self.graph.replay()


def _clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, Camera):
        return dataclasses.replace(x, **{
            f.name: _clone_tree(getattr(x, f.name))
            for f in dataclasses.fields(Camera)
            if f.name not in CAMERA_STATIC})
    if isinstance(x, optim.AdamState):
        return optim.AdamState(*(_clone_tree(v) for v in x))
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    return x


def _leaves(x, prefix=""):
    """[(path, tensor or static value)] of a state tree, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [(prefix, x)]
    if isinstance(x, Camera):
        return [(f"{prefix}.{f.name}", getattr(x, f.name))
                for f in dataclasses.fields(Camera)]
    if isinstance(x, optim.AdamState):
        return sum((_leaves(v, f"{prefix}.{k}")
                    for k, v in zip(x._fields, x)), [])
    if isinstance(x, dict):
        return sum((_leaves(x[k], f"{prefix}.{k}") for k in sorted(x)), [])
    return [(prefix, x)]


def _signature(tree) -> tuple:
    """Shapes, dtypes and devices of a tree's tensors and its other values:
    what a captured graph depends on besides the tensors' contents."""
    return tuple((p, tuple(v.shape), v.dtype, v.device)
                 if isinstance(v, torch.Tensor) else (p, repr(v))
                 for p, v in _leaves(tree))


class _Static:
    """The buffers a captured step reads and writes."""

    def __init__(self, tree, sel: torch.Tensor, device):
        self.tree = _clone_tree(tree)
        self.sel = sel.to(device).clone()
        self.i = torch.zeros((), dtype=torch.int64, device=device)
        self.hist_f = self.hist_i = None
        self.f_keys: List[str] = []
        self.i_keys: List[str] = []
        self.i_dtypes: Dict[str, torch.dtype] = {}
        self.written_vars: List[str] = []

    def load(self, tree, sel: torch.Tensor) -> None:
        for (_, dst), (_, src) in zip(_leaves(self.tree), _leaves(tree)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        self.sel.copy_(sel)
        self.i.zero_()


class StepWindow:
    """`make_train_scan`'s callable on the card (or, with a stub
    `graph_factory`, anywhere): (params, opt_state, variables, data_stack,
    cam_sel, lrs, is_initial) -> (params, opt_state, variables, metrics),
    the metrics of the last step except `SUMMED`, summed over the window
    (`window_metrics`). `k_slots`: the train step's emission slots per
    gaussian (K).

    `stats`: captures, replays, eager steps, redos, the pair capacity, the
    largest live-pair count of the last window and the host milliseconds of
    the last capture. `last_steps`: the metrics of each step of the last
    window ({key: (W,) tensor}).
    """

    def __init__(self, train_step, k_slots: int,
                 graph_factory: Optional[Callable] = None):
        self.train_step = train_step
        self.k_slots = k_slots
        self.graph_factory = graph_factory or CudaGraph
        self.pair_cap: Optional[int] = None
        self.stats = dict(captures=0, replays=0, eager_steps=0, redos=0,
                          pair_cap=None, max_live=None, capture_ms=None)
        self.last_steps: Dict[str, torch.Tensor] = {}
        self._st: Optional[_Static] = None
        self._sig = None
        self._graph = None
        self._graph_key = None
        self._side = None

    def set_step(self, train_step, k_slots: int) -> None:
        """Go on with another train step (K escalated): the pair capacity
        stays, the step is captured again at the next window."""
        self.train_step, self.k_slots = train_step, k_slots
        self._graph = None

    # -- one step on the static buffers ---------------------------------
    def _step(self, st: _Static, cap: Optional[int],
              is_initial: bool) -> None:
        """One step on the static buffers; cap None: the eager table."""
        tree = st.tree
        row = st.sel.index_select(0, st.i.reshape(1))[0]
        batch = batch_at(tree["data"], row)
        p, o, v, m = self.train_step(tree["params"], tree["opt"],
                                     tree["vars"], batch, tree["lrs"],
                                     is_initial, pair_cap=cap,
                                     pair_stats=True)
        for k, t in p.items():
            tree["params"][k].copy_(t)
        for name in ("mu", "nu"):
            for k, t in getattr(o, name).items():
                getattr(tree["opt"], name)[k].copy_(t)
        tree["opt"].step.copy_(o.step)
        written = []
        for k, t in v.items():
            if t is not tree["vars"][k]:
                tree["vars"][k].copy_(t)
                written.append(k)
        if st.hist_f is None:      # the first step on these buffers: eager
            st.f_keys = sorted(k for k, t in m.items()
                               if t.is_floating_point())
            st.i_keys = sorted(k for k, t in m.items()
                               if not t.is_floating_point())
            st.i_dtypes = {k: m[k].dtype for k in st.i_keys}
            n = st.sel.shape[0]
            dev = st.i.device
            st.hist_f = torch.zeros((n, len(st.f_keys)), dtype=torch.float32,
                                    device=dev)
            st.hist_i = torch.zeros((n, len(st.i_keys)), dtype=torch.int64,
                                    device=dev)
            st.written_vars = written
        at = st.i.reshape(1)
        st.hist_f.index_copy_(0, at, torch.stack(
            [m[k].to(torch.float32) for k in st.f_keys])[None])
        st.hist_i.index_copy_(0, at, torch.stack(
            [m[k].to(torch.int64) for k in st.i_keys])[None])
        st.i += 1

    def _eager(self, st: _Static, cap: Optional[int],
               is_initial: bool) -> None:
        with span("window.eager"):
            dev = st.i.device
            if dev.type != "cuda":
                self._step(st, cap, is_initial)
            else:
                # warm-up on a side stream, as CUDA graph capture wants it
                if self._side is None:
                    self._side = torch.cuda.Stream(dev)
                cur = torch.cuda.current_stream(dev)
                self._side.wait_stream(cur)
                with torch.cuda.stream(self._side):
                    self._step(st, cap, is_initial)
                cur.wait_stream(self._side)
        self.stats["eager_steps"] += 1

    def _capture(self, st: _Static, cap: int, is_initial: bool) -> None:
        self._graph = None
        graph = self.graph_factory()
        t0 = time.perf_counter()
        with span("window.capture"):
            graph.capture(lambda: self._step(st, cap, is_initial))
        self._graph = graph
        self.stats["captures"] += 1
        self.stats["capture_ms"] = (time.perf_counter() - t0) * 1e3

    # -- one window ------------------------------------------------------
    def _window(self, tree, sel: torch.Tensor, is_initial: bool,
                n_slots: int):
        n = sel.shape[0]
        sig = (_signature(tree), tuple(sel.shape))
        with span("window.load"):
            if self._st is None or self._sig != sig:
                self._st, self._sig = _Static(tree, sel, sel.device), sig
                self._graph = None
            else:
                self._st.load(tree, sel)
        st = self._st
        done = 0
        if self.pair_cap is None:
            # the first window's first step, with the eager table: its
            # live-pair count sets the capacity
            self._eager(st, None, is_initial)
            done = 1
            n_live = n_slots            # a render without a pair table
            if "n_live_pairs" in st.i_keys:
                n_live = int(st.hist_i[0, st.i_keys.index("n_live_pairs")])
            self.pair_cap = pair_capacity(n_live, n_slots)
        key = (self.pair_cap, is_initial, self.k_slots, tracing())
        if done < n and (self._graph is None or self._graph_key != key):
            self._eager(st, self.pair_cap, is_initial)
            done += 1
            self._capture(st, self.pair_cap, is_initial)
            self._graph_key = key
        for _ in range(n - done):
            with span("window.replay"):
                self._graph.replay()
        self.stats["replays"] += n - done

        with span("window.read"):       # the window's one host read
            hist_i = st.hist_i[:n].cpu()
        if "n_live_pairs" in st.i_keys:
            ki = st.i_keys
            max_live = int(hist_i[:, ki.index("n_live_pairs")].max())
            overflow = int(hist_i[:, ki.index("n_pair_overflow")].sum())
            self.stats["max_live"] = max_live
            if overflow > 0:
                self.pair_cap = max(pair_capacity(max_live, n_slots),
                                    min(n_slots, int(self.pair_cap * GROW)))
                self.stats["pair_cap"] = self.pair_cap
                return None
            need = pair_capacity(max_live, n_slots)
            if self.pair_cap > SHRINK * need:
                self.pair_cap = need
        self.stats["pair_cap"] = self.pair_cap
        with span("window.result"):
            return self._result(st, tree, n)

    def _result(self, st: _Static, tree, n: int):
        out = st.tree
        params = {k: t.clone() for k, t in out["params"].items()}
        opt = optim.AdamState(
            mu={k: t.clone() for k, t in out["opt"].mu.items()},
            nu={k: t.clone() for k, t in out["opt"].nu.items()},
            step=out["opt"].step.clone())
        variables = dict(tree["vars"])
        for k in st.written_vars:
            variables[k] = out["vars"][k].clone()
        steps = {k: st.hist_f[:n, c].clone()
                 for c, k in enumerate(st.f_keys)}
        steps.update({k: st.hist_i[:n, c].clone()
                      for c, k in enumerate(st.i_keys)})
        self.last_steps = steps
        # each column in its metric's dtype once, then a view per step
        cols = {k: v.to(st.i_dtypes.get(k, torch.float32))
                for k, v in steps.items() if k not in PAIR_KEYS}
        per_step = [{k: v[j] for k, v in cols.items()} for j in range(n)]
        return params, opt, variables, window_metrics(per_step)

    def __call__(self, params, opt_state, variables, data_stack, cam_sel,
                 lrs, is_initial: bool):
        dev = variables["alive"].device
        sel = torch.as_tensor(cam_sel, dtype=torch.int64).to(dev)
        tree = {"params": params, "opt": opt_state, "vars": variables,
                "data": data_stack, "lrs": lrs}
        n_slots = self.k_slots * variables["alive"].shape[0]
        while True:
            out = self._window(tree, sel, is_initial, n_slots)
            if out is not None:
                return out
            self.stats["redos"] += 1
