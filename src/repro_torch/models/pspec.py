"""Activation sharding anchors with logical axis names.

The PyTorch port's counterpart of the JAX package's ``models/pspec.py``.
``constrain(x, "dp", None, "model")`` resolves "dp" to ("pod", "data")
when the ambient mesh (``launch.mesh.mesh_context``) has a pod axis,
checks divisibility per dim, and redistributes a ``DTensor`` to the
matching placements; without an ambient mesh, or on a plain tensor, it
returns ``x`` itself. These anchors keep the token dimension sharded over
the data axes where the weights' placements would otherwise pull the
activations elsewhere, as the reference's anchors keep GSPMD from
replicating it.

A tensor the forward makes from shapes alone (positions, masks, rotary
tables) is a plain tensor even when the model's parameters are DTensors;
``lift(t, x)`` puts it on ``x``'s mesh as ``Replicate()`` so the two can
meet in one operation, which GSPMD did for the reference by itself.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..launch.mesh import current_mesh

# experiment knob (the reference's §Perf A6/B2): resolve "dp" to include
# the model axis (pure-DP layouts that use every device for the batch)
DP_INCLUDE_MODEL = False


def resolve_spec(spec, shape, names, sizes, *,
                 dp_include_model: bool = None):
    """Resolve logical axis names against mesh (names, sizes) per dim.

    Pure function of the spec, the array shape, and the mesh geometry:
    ``constrain`` feeds it the ambient mesh; tests feed it synthetic
    geometries. Any dim whose size is not divisible by the product of its
    mesh axes falls back to ``None`` (replicated).
    """
    if dp_include_model is None:
        dp_include_model = DP_INCLUDE_MODEL
    sizes = dict(sizes)
    resolved = []
    for dim, s in enumerate(spec):
        if s == "dp":
            cand = ("pod", "data", "model") if dp_include_model \
                else ("pod", "data")
            axes = tuple(a for a in cand if a in names)
            n = 1
            for a in axes:
                n *= sizes[a]
            resolved.append(axes if axes and shape[dim] % n == 0 else None)
        elif s is None:
            resolved.append(None)
        else:
            ok = s in names and shape[dim] % sizes[s] == 0
            resolved.append(s if ok else None)
    return tuple(resolved)


def placements(spec, names) -> tuple:
    """A resolved spec (per tensor dim: None, an axis name or a tuple of
    them) as DTensor placements, one per mesh dim of ``names``: ``Shard(d)``
    on every mesh dim that shards tensor dim d (a dim over ("pod", "data")
    is ``Shard(d)`` on both, split over pod first), else ``Replicate()``."""
    where = {}
    for dim, axes in enumerate(spec):
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            where[a] = dim
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


def mesh_geometry(mesh) -> tuple:
    """(axis names, ((name, size), ...)) of a ``DeviceMesh``, or of any
    object with its ``mesh_dim_names`` and ``shape``."""
    names = tuple(mesh.mesh_dim_names)
    return names, tuple(zip(names, tuple(mesh.shape)))


def divides(x, axis: str, n: int) -> bool:
    """Whether ``x`` is a DTensor whose mesh has ``axis`` and the axis's
    size divides ``n``."""
    if not isinstance(x, DTensor):
        return False
    names, sizes = mesh_geometry(x.device_mesh)
    return axis in names and n % dict(sizes)[axis] == 0


def placements_on(x, spec, shape=None) -> tuple:
    """The placements that the logical ``spec`` resolves to on the mesh of
    the DTensor ``x``, for ``shape`` (default ``x``'s)."""
    names, sizes = mesh_geometry(x.device_mesh)
    return placements(resolve_spec(spec, x.shape if shape is None
                                   else shape, names, sizes), names)


def on_shards(fn, in_placements, out_placements, *tensors):
    """``fn`` run on each device's local shards of the DTensors
    ``tensors``, each first redistributed to its ``in_placements``; its
    outputs become DTensors of ``out_placements`` (one placement tuple for
    each output). For work that is independent across the sharded dims
    (attention over batch and heads), which then runs on plain tensors.
    Where the work splits over a mesh dim that an input is replicated on
    (a per-head constant beside a batch-sharded panel, a panel shared by
    every head beside head-sharded ones), that input's gradient is a
    partial sum over the mesh dim (``Partial()``)."""
    split = [any(isinstance(p[i], Shard) for p in in_placements)
             for i in range(len(in_placements[0]))]
    grads = tuple(tuple(Partial() if cut and isinstance(p_i, Replicate)
                        else p_i for cut, p_i in zip(split, p))
                  for p in in_placements)
    out = [list(p) for p in out_placements]

    def local(*ts):
        # contiguous local tensors both ways: a DTensor over a strided
        # local tensor can meet a view that its layout does not allow
        ts = [_GradContiguous.apply(t) if t.requires_grad else t for t in ts]
        res = fn(*ts)
        if isinstance(res, tuple):
            return tuple(r.contiguous() for r in res)
        return res.contiguous()

    return local_map(local, out_placements=out[0] if len(out) == 1
                     else tuple(out), in_placements=tuple(in_placements),
                     in_grad_placements=grads,
                     device_mesh=tensors[0].device_mesh,
                     redistribute_inputs=True)(*tensors)


class _GradContiguous(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def constrain(x, *spec):
    """``x`` redistributed to the placements that ``spec`` resolves to on
    the ambient mesh; ``x`` itself without one, or for a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    names, sizes = mesh_geometry(mesh)
    want = placements(resolve_spec(spec, x.shape, names, sizes), names)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def lift(t, like):
    """``t`` as a ``Replicate()`` DTensor on the mesh of ``like`` when
    ``like`` is a DTensor and ``t`` is not; else ``t`` itself. ``t`` must
    hold the same values on every rank (it is made from shapes)."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole(t):
    """A DTensor gathered whole (``full_tensor``) on every rank, through
    autograd; a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


class _GradAsInput(torch.autograd.Function):
    """Identity whose backward puts the gradient on its input's
    placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.spec = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.spec) if isinstance(g, DTensor) else g


def grad_as_input(x):
    """``x`` itself; in the backward pass its gradient takes ``x``'s
    placements before it reaches the operation that made ``x`` (a
    reduction's gradient comes back replicated, and an elementwise
    backward would otherwise gather ``x`` whole to meet it). A plain
    tensor passes through untouched."""
    return _GradAsInput.apply(x) if isinstance(x, DTensor) else x
