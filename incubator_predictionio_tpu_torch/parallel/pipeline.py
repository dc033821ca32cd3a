"""Pipeline parallelism: the GPipe schedule over a ``pipe`` mesh axis.

Counterpart of ``incubator_predictionio_tpu/parallel/pipeline.py``
(:func:`stack_layers` :37, :func:`pipeline_forward` :45): the layer stack
is split into S contiguous stages, one per process of a ``pipe`` line
(:func:`stage_slice`); M microbatches flow through the M + S − 1 steps of
the GPipe schedule, each stage handing its output to the next through
:meth:`~incubator_predictionio_tpu_torch.parallel.mesh.DeviceContext.ppermute`
(the reference's ``jax.lax.ppermute``, here its partial form: the last
stage sends nothing on). The reference's bubble steps compute values that
are never collected; :class:`GPipe` skips them (a stage computes
microbatch ``t − stage`` at step ``t`` when it exists) and its members
still meet at every step's exchange, so a stage with nothing to hand on
sends zeros.

Where the reference differentiates the whole scan with one ``jax.grad``,
the port runs the backward as an explicit schedule (:meth:`GPipe.backward`):
microbatches in reverse order, each stage taking its output's gradient
from the next stage (the reverse shift, ppermute's transpose), running
that microbatch's graph backward from it (:func:`backward_with`) and
handing its input's gradient to the previous stage. No collective runs inside
autograd, so the order of the exchanges never depends on the engine's.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def stack_layers(layers: list[dict]) -> dict:
    """pipeline.py:37: a list of layer trees → one tree whose leaves have
    a leading ``[n_layers]`` dim: numpy arrays on the host, or tensors
    (the stack of meta tensors is made as its shape alone, without the
    decompositions PyTorch loads for a meta op's first call)."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        if not isinstance(xs[0], torch.Tensor):
            return np.stack([np.asarray(x) for x in xs])
        if xs[0].device.type == "meta":
            return torch.empty((len(xs), *xs[0].shape), dtype=xs[0].dtype,
                               device="meta")
        return torch.stack(xs)

    return stack(*layers)


def backward_with(t: torch.Tensor, grad: torch.Tensor) -> None:
    """Backpropagate ``grad``, the gradient of ``t``, into the graph that
    made ``t``: the backward of ``Σ t·grad``, whose gradient at ``t`` is
    ``1·grad``, bit for bit ``grad``. (``torch.autograd.backward(t, grad)``
    gives the same, but its check of ``grad``'s shape imports sympy on its
    first call in a process: seconds of a launched stage's first step.)"""
    torch.autograd.backward((t * grad.detach()).sum())


def stage_slice(n_layers: int, n_stages: int, stage: int) -> slice:
    """The contiguous layers stage ``stage`` of ``n_stages`` holds (the
    reference's ``P("pipe")`` split of the stacked layers' leading dim)."""
    if n_layers % n_stages:
        raise ValueError(
            f"n_layers={n_layers} not divisible by pipe axis {n_stages}")
    k = n_layers // n_stages
    return slice(stage * k, (stage + 1) * k)


class GPipe:
    """One stage's part of the GPipe schedule over its ``axis`` line of
    ``mesh``: ``n_microbatches`` microbatches, this process's stage
    ``stage`` of ``size``. :meth:`forward` keeps each microbatch's input
    and output for :meth:`backward`. ``clock`` (a
    :class:`~incubator_predictionio_tpu_torch.parallel.mesh.CollectiveClock`)
    times the handoffs; :attr:`bytes` counts the bytes this stage sends."""

    def __init__(self, mesh, n_microbatches: int, axis: str = "pipe",
                 clock=None):
        self.mesh, self.axis, self.m = mesh, axis, n_microbatches
        self.size = mesh.axis_size_or(axis)
        self.stage = mesh.axis_index(axis)
        self.clock = clock
        self.bytes = 0
        self._ins: list = []
        self._outs: list = []

    @property
    def last(self) -> bool:
        return self.stage == self.size - 1

    def _handoff(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """Every member's exchange of one step: ``t`` to the next stage
        (``shift`` 1) or the previous one (-1); what arrives (zeros on the
        stage at the end the shift leaves empty)."""
        if 0 <= self.stage + shift < self.size:
            self.bytes += t.numel() * t.element_size()

        def run():
            return self.mesh.ppermute(t, self.axis, shift, cyclic=False)

        return run() if self.clock is None else self.clock.time(run)

    def forward(self, h0: torch.Tensor, stage_fn: Callable) -> list:
        """Run the schedule's forward: ``h0`` ``[B, ...]`` is the batch
        (only stage 0 reads its values; every stage passes one of its
        shape), ``stage_fn(x) -> y`` this stage's layers. Returns the last
        stage's M outputs (the hidden states, in microbatch order; an
        empty list on the other stages). With a gradient enabled each
        microbatch's input is a leaf of its own graph, for
        :meth:`backward`."""
        b = h0.shape[0]
        if b % self.m:
            raise ValueError(
                f"batch {b} not divisible by n_microbatches {self.m}")
        chunks = h0.split(b // self.m)
        grad = torch.is_grad_enabled()
        steps = self.m + self.size - 1
        self._ins, self._outs = [None] * self.m, [None] * self.m
        self._zeros = torch.zeros_like(chunks[0])  # a bubble step's send
        received = None
        for t in range(steps):
            i = t - self.stage
            y = None
            if 0 <= i < self.m:
                x = chunks[i] if self.stage == 0 else received
                if grad:
                    x = x.detach().requires_grad_(True)
                self._ins[i] = x
                y = self._outs[i] = stage_fn(x)
            if t < steps - 1:  # the last step's outputs are the final ones
                received = self._handoff(
                    y.detach() if y is not None else self._zeros, 1)
        return list(self._outs) if self.last else []

    def backward(self, grads: Optional[list]) -> Optional[torch.Tensor]:
        """Run the schedule's backward after :meth:`forward`: ``grads`` are
        the last stage's outputs' gradients (None on the other stages).
        Microbatches in reverse order; each stage backpropagates a
        microbatch through its layers (the parameters' ``.grad``
        accumulate) and hands its input's gradient to the previous stage.
        Returns, on stage 0, the gradient of ``h0`` ``[B, ...]`` (None on
        the others)."""
        steps = self.m + self.size - 1
        first = self.size - 1 - self.stage  # this stage's first backward step
        gin = [None] * self.m
        received = None
        for t in range(steps):
            j = t - first
            g_in = None
            if 0 <= j < self.m:
                i = self.m - 1 - j
                g = grads[i] if self.last else received
                backward_with(self._outs[i], g)
                g_in = gin[i] = self._ins[i].grad
                self._outs[i] = self._ins[i] = None  # the graph is spent
            if t < steps - 1:
                received = self._handoff(
                    g_in if g_in is not None else self._zeros, -1)
        self._ins, self._outs = [], []
        return torch.cat(gin) if self.stage == 0 else None


def pipeline_forward(stage_layers, h0, apply_layer: Callable, mesh,
                     n_microbatches: int, axis: str = "pipe") -> torch.Tensor:
    """pipeline.py:45: ``h0`` ``[B, L, D]`` through the pipelined layer
    stack → ``[B, L, D]`` on every stage of the line (the last stage's
    outputs summed over ``pipe`` with zeros, as the reference's ``psum``).
    ``stage_layers`` is this process's stage's layers (a list of layer
    trees, :func:`stage_slice` of the stack); ``apply_layer(layer, h) ->
    h`` the single-layer body. ``h0`` is this process's rows: the data
    shard needs no argument here, since each process holds its own. No
    gradient: training runs :class:`GPipe`'s two schedules."""
    def stage_fn(x):
        for layer in stage_layers:
            x = apply_layer(layer, x)
        return x

    pipe = GPipe(mesh, n_microbatches, axis)
    with torch.no_grad():
        outs = pipe.forward(h0, stage_fn)
        h = torch.cat(outs) if pipe.last else torch.zeros_like(h0)
        return mesh.all_reduce_sum(h, axis=axis)
