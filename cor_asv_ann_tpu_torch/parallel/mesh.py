"""Device mesh and sharding layout over several GPUs.

Port of the JAX package's ``parallel/mesh.py``. The JAX package is one
process that sees all its devices, and XLA's GSPMD inserts the
collectives. PyTorch's idiom is one process per device (``torchrun``,
``torch.distributed``), so here a mesh is a ('data', 'model') grid over
the ranks of a process group, and every rank holds only its own part:

- batches are sharded over 'data': a rank keeps its rows (`shard_batch`),
  or the whole batch when the batch does not divide the data axis;
- the wide parameter matrices are sharded over 'model' along their last
  axis (`param_sharding`, the JAX rule leaf for leaf): a rank keeps its
  slice (`shard_params`) and gathers the full weights where it computes
  (`gather_params`), so the ranks of one data row compute alike: the
  'model' axis divides the weights' storage, not the work (GSPMD splits
  the products over it in the JAX package);
- results and gradients meet through the collectives below. They are
  written in ``all_reduce`` and ``broadcast`` only, so that one code path
  runs on NCCL and on gloo with CUDA tensors (gloo takes CUDA tensors for
  those two only). A gather is an ``all_reduce`` into a zero buffer of
  the global shape in which each rank writes its own part: adding zeros
  is exact.

A world of 1 is the 1x1 mesh of the JAX docstring. `make_mesh`
initialises one (NCCL on a CUDA device, gloo on the CPU) when the caller
has no process group, and says so in the log.
"""

import logging
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .. import resolve_device
from ..models.params import tree_leaves, tree_map, tree_unflatten

logger = logging.getLogger(__name__)


class Mesh:
    """A ('data', 'model') grid over the ranks of the default process
    group: rank r sits at row r // tp, column r % tp, the row-major order
    of the JAX package's device array. ``shape`` maps the axis names to
    their sizes, as ``jax.sharding.Mesh.shape`` does; ``device_mesh`` is
    the ``DeviceMesh`` whose groups the collectives use."""

    def __init__(self, data, model, device):
        self.shape = {'data': data, 'model': model}
        self.device = device
        self.rank = dist.get_rank()
        self.data_index, self.model_index = divmod(self.rank, model)
        if device.type == 'cuda':
            # DeviceMesh picks a device for a process that has none yet;
            # this one has been chosen by the caller
            torch.cuda.set_device(device)
            torch.zeros(1, device=device)
        self.device_mesh = DeviceMesh(
            device.type, torch.arange(data * model).reshape(data, model),
            mesh_dim_names=('data', 'model'))
        self.data_group = self.device_mesh.get_group('data')
        self.model_group = self.device_mesh.get_group('model')

    def local_rows(self, batch):
        """This rank's rows of a batch of `batch` rows: a slice when the
        data axis divides it, else None (every rank holds the whole
        batch, the JAX package's replicated placement)."""
        dp = self.shape['data']
        if batch % dp:
            return None
        n = batch // dp
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def sum_over(self, tensor, axis):
        """All-reduce (sum) `tensor` in place over the ranks of one axis
        ('data' or 'model'); returns it."""
        group = self.data_group if axis == 'data' else self.model_group
        dist.all_reduce(tensor, group=group)
        return tensor

    def broadcast(self, tensor):
        """Give every rank rank 0's `tensor` (in place); returns it."""
        dist.broadcast(tensor, src=0)
        return tensor

    def barrier(self):
        """Wait until every rank of the mesh arrives (an all_reduce of
        one value over the whole world)."""
        dist.all_reduce(torch.ones(1, device=self.device))


def _init_world(device):
    """The default process group for a caller that has none: from
    ``torchrun``'s environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) when it is set, else a world of 1 on an in-process
    store."""
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
        dist.init_process_group(backend, init_method='env://')
        return
    logger.info('no process group: initialising a world of 1 (%s on %s)',
                backend, device)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(n_devices=None, data_axis=None, device=None):
    """Create a ('data', 'model') mesh over the ranks of the default
    process group, initialising one (`_init_world`) where the caller has
    none. `device` is this rank's device (default: the current CUDA
    device; pass 'cpu' for gloo on the CPU).

    `n_devices` must be None, -1 or the world's size: a single JAX
    process can take a subset of its devices, but a rank cannot lend its
    device to another. `data_axis` fixes the data-parallel degree; by
    default all ranks go to data parallelism except at 4+ even ranks,
    where a 2-way model axis is carved out (the JAX rule)."""
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    if not dist.is_initialized():
        _init_world(device)
    n = dist.get_world_size()
    if n_devices not in (None, -1, n):
        raise ValueError('requested %d mesh devices but %d are available'
                         % (n_devices, n))
    if data_axis is None:
        model = 2 if n % 2 == 0 and n >= 4 else 1
        data_axis = n // model
    if n % data_axis:
        raise ValueError(
            'data_axis %d does not divide the %d available devices'
            % (data_axis, n))
    return Mesh(data_axis, n // data_axis, device)


def _spec(shape, nmodel):
    """The placements over ('data', 'model') of one parameter of this
    shape: the JAX package's rule."""
    if len(shape) >= 2 and shape[-1] % nmodel == 0 \
            and shape[-1] >= nmodel * 8:
        # (in, 4W) gate kernels, (V, W) embedding, (A, W)/(W, W)
        # projections: shard the wide output axis
        return (Replicate(), Shard(len(shape) - 1))
    if len(shape) == 1 and shape[0] >= 128 and shape[0] % nmodel == 0:
        return (Replicate(), Shard(0))
    return (Replicate(), Replicate())


def param_sharding(params, mesh):
    """Per leaf of the parameter tree (numpy arrays or tensors of the
    full shapes), its placements over ('data', 'model'): wide matmul
    operands sharded over 'model' along their last axis, small vectors
    replicated."""
    nmodel = mesh.shape['model']
    return tree_map(lambda leaf: _spec(tuple(leaf.shape), nmodel), params)


def batch_sharding(mesh, batch):
    """The placements of a batch of `batch` rows: its leading axis over
    'data' when the data axis divides it, else replicated."""
    if mesh.local_rows(batch) is None:
        return replicated(mesh)
    return (Shard(0), Replicate())


def replicated(mesh):
    return (Replicate(), Replicate())


def _slice_of(tensor, spec, mesh):
    """This rank's part of a full leaf under its placements."""
    if isinstance(spec[1], Shard):
        n = tensor.shape[-1] // mesh.shape['model']
        tensor = tensor[..., mesh.model_index * n:(mesh.model_index + 1) * n]
    return tensor


def shard_params(params, mesh):
    """This rank's parameters, as copies on the mesh's device: the slice
    of every leaf sharded over 'model', the whole of the others. Takes a
    tree of numpy arrays or tensors of the full shapes (the parameters,
    or Adam moments in their layout)."""
    specs = param_sharding(params, mesh)

    def take(leaf, spec):
        t = (leaf if isinstance(leaf, torch.Tensor)
             else torch.from_numpy(np.array(leaf, order='C')))
        return _slice_of(t.detach(), spec, mesh).contiguous().to(
            mesh.device, copy=True)

    return tree_map(take, params, specs)


def shard_batch(arrays, mesh):
    """This rank's rows of each array of a batch, as tensors on the
    mesh's device (all rows where the data axis does not divide the
    batch, `batch_sharding`)."""
    rows = mesh.local_rows(len(arrays[0]))
    return tuple(torch.as_tensor(a if rows is None else a[rows])
                 .to(mesh.device) for a in arrays)


class _GatherModel(torch.autograd.Function):
    """(mesh, full shapes, *slices) -> the full leaves: one all_reduce over
    'model' of a zero buffer in which every rank writes its slices. The
    gradient of a slice is its part of the full leaf's gradient; nothing
    is summed over 'model', since the ranks of a data row compute the
    same full gradient."""

    @staticmethod
    def forward(ctx, mesh, shapes, *slices):
        dtype = slices[0].dtype
        if any(s.dtype != dtype for s in slices):
            raise ValueError('gather_params: leaves of one dtype expected')
        sizes = [math.prod(shape) for shape in shapes]
        buf = torch.zeros(sum(sizes), dtype=dtype, device=slices[0].device)
        fulls = [part.view(shape) for part, shape in
                 zip(torch.split(buf, sizes), shapes)]
        m = mesh.model_index
        for full, s in zip(fulls, slices):
            n = s.shape[-1]
            full[..., m * n:(m + 1) * n] = s
        mesh.sum_over(buf, 'model')
        ctx.mesh = mesh
        ctx.widths = [s.shape[-1] for s in slices]
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        m = ctx.mesh.model_index
        return (None, None, *(g[..., m * n:(m + 1) * n].contiguous()
                              for g, n in zip(grads, ctx.widths)))


def gather_params(params, shapes, mesh):
    """The full parameters from this rank's `shard_params` slices: each
    leaf whose shape differs from its full shape in `shapes` (a tree of
    the same layout whose leaves carry the full shapes: the full
    parameters, or tensors on the 'meta' device) is gathered over
    'model' along its last axis, all in one all_reduce; the others pass
    through. Differentiable (`_GatherModel`)."""
    leaves = tree_leaves(params)
    full = [tuple(s.shape) for s in tree_leaves(shapes)]
    picked = [i for i, (leaf, shape) in enumerate(zip(leaves, full))
              if tuple(leaf.shape) != shape]
    if not picked:
        return params
    gathered = _GatherModel.apply(mesh, [full[i] for i in picked],
                                  *[leaves[i] for i in picked])
    for i, g in zip(picked, gathered):
        leaves[i] = g
    return tree_unflatten(params, leaves)


class _SumOverData(torch.autograd.Function):
    """(mesh, *tensors) -> the same tensors; backward: their gradients
    summed over 'data' in one all_reduce. The counterpart of
    ``shard_map``'s transpose of a replicated input: applied to the
    parameters before a step that sees only this rank's rows, it makes
    every parameter gradient the whole batch's."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tensors if len(tensors) > 1 else tensors[0]

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        ctx.mesh.sum_over(flat, 'data')
        parts = torch.split(flat, [g.numel() for g in grads])
        return (None, *(p.view(g.shape).to(g.dtype)
                        for p, g in zip(parts, grads)))


def sum_over_data(params, mesh):
    """The parameter tree through `_SumOverData`: the same values, whose
    gradients come back summed over 'data'."""
    leaves = tree_leaves(params)
    out = _SumOverData.apply(mesh, *leaves)
    return tree_unflatten(params, list(out) if len(leaves) > 1 else [out])


def gather_batch(tensor, mesh, rows):
    """The whole batch of a result of which this rank computed the rows
    `rows` (`Mesh.local_rows`; None: it computed them all): an
    all_reduce over 'data' of a zero buffer of the global shape. Reduced
    in float32 where the tensor is of a narrower float type (exact)."""
    if rows is None:
        return tensor
    dtype = tensor.dtype
    wide = torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype
    n = tensor.shape[0]
    buf = torch.zeros((n * mesh.shape['data'],) + tuple(tensor.shape[1:]),
                      dtype=wide, device=tensor.device)
    buf[rows] = tensor
    return mesh.sum_over(buf, 'data').to(dtype)


def sync_host_rng(mesh):
    """Give every rank rank 0's state of numpy's global generator (one
    broadcast), so that the host's draws (validation split, batch order,
    encoder degradation, scheduled sampling) are alike on every rank and
    equal to a single process's."""
    kind, keys, pos, has_gauss, cached = np.random.get_state()
    state = torch.tensor(np.concatenate(
        [keys.astype(np.float64), [pos, has_gauss, cached]]),
        dtype=torch.float64, device=mesh.device)
    state = mesh.broadcast(state).cpu().numpy()
    np.random.set_state((kind, state[:-3].astype(np.uint32),
                         int(state[-3]), int(state[-2]), float(state[-1])))
