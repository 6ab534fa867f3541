"""The parallel layer: a mesh of named axes over the ranks of a
``torch.distributed`` group, and the data-, tensor-, context- and
pipeline-parallel paths on it.

Counterpart of ``ppgs_tpu/parallel/``. The JAX package expresses
parallelism as a ``jax.sharding.Mesh`` plus NamedSharding rules, and XLA
(GSPMD) inserts the collectives from the annotations. Here each rank is
one process on one device, and each collective is an explicit call on a
process group (``comm.py``):

- ``make_mesh`` takes JAX's (shape, axis names) with one -1 and lays the
  ranks out row-major; for each axis it builds the process group of the
  ranks that differ only along it (``Mesh.group``);
- ``batch_sharding`` / ``shard_batch`` give a rank its block of the
  leading dim (along 'data' by default); ``replicate`` broadcasts rank 0's
  values; ``pad_batch_to_multiple`` keeps the -100 contract of targets;
- the TP rules ``w2v2_param_sharding`` and ``conformer_param_sharding``
  keep JAX's name matching on the JAX-layout parameter paths and return
  the dim of each parameter that splits over the axis (None: replicated);
  ``shard_params`` keeps a rank's slices;
- ``shard_module`` applies a rule to a port module (its parameters and the
  compute-dtype copies ``convert.prepare_*`` made), keeping each rank's
  slices, and returns a ``TPView``: the module as the model code reads
  it, whose sharded tensors are all-gathered when a layer reads them, just
  before its fused kernel runs on the whole weight, and dropped with the
  layer. The kernels take fixed widths (``models.transformer
  .KERNEL_WIDTHS``; K3 and K4 fuse the row-parallel product with the
  residual and the LayerNorm, which cannot be split across an all-reduce),
  so TP keeps the weights (and Adam's moments) sharded and computes on the
  whole weight: what XLA's partitioner does around a Pallas call that it
  cannot split. With a gradient, the gather's backward is a reduce-scatter
  over the replicas of the layer, which all compute the same rows, scaled
  by 1 / their count;
- ``frontend_tp_placement`` caches a frontend's sharded view per (rule,
  mesh, parameter identity), as the JAX package does, and is None on one
  rank.

``_shard_map.py`` (JAX-version glue for ``shard_map``) has no counterpart:
the per-rank bodies of ``context.py`` and ``pipeline.py`` take its place.
"""

import copy
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import comm


###############################################################################
# Mesh
###############################################################################


class Mesh:
    """Named axes over the ranks of the default process group, row-major
    (rank r sits at ``np.unravel_index(r, shape)``, as ``make_mesh``
    reshapes JAX's device list). ``shape`` is {axis: size}, as a JAX
    mesh's; ``index(axis)`` is this rank's coordinate, ``group(axis)`` the
    process group of the ranks along ``axis`` through this rank."""

    def __init__(self, shape, axis_names, rank, groups):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(rank, tuple(shape)))))
        self._groups = groups

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))

    def index(self, axis):
        """This rank's coordinate along ``axis`` (0 for an absent axis)."""
        return self.coords.get(axis, 0)

    def group(self, axes):
        """The process group of the ranks along ``axes`` (an axis name, or a
        tuple of names: the ranks that differ only along those axes)
        through this rank; None without a process group, or when they are
        one rank of a larger one. A tuple's group is built on first use:
        every rank asks for it at the same point."""
        if isinstance(axes, str):
            return self._groups.get(axes)
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) == 1:
            return self._groups.get(axes[0])
        if axes not in self._groups:
            self._groups[axes] = _line_group(
                tuple(self.shape.values()),
                [self.axis_names.index(a) for a in axes], self.rank)
        return self._groups[axes]

    def __repr__(self):
        return f'Mesh({self.shape}, rank={self.rank})'


_MESHES: Dict[tuple, Mesh] = {}


def world():
    """(world size, rank) of the default process group; (1, 0) without."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def fill_shape(shape, count):
    """``shape`` with its -1 (at most one) set so that the product is
    ``count`` (JAX's fill: count // the other sizes)."""
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = count // max(known, 1)
    return tuple(int(s) for s in shape)


def make_mesh(shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ('data',)) -> Mesh:
    """The mesh of ``shape`` over the ranks (one -1 fills with the world
    size). Every rank calls it with the same arguments, in the same order:
    building an axis's groups is collective. Meshes are cached per (shape,
    names, process group), so the groups are built once."""
    count, rank = world()
    shape = fill_shape(shape, count)
    if len(shape) != len(axis_names):
        raise ValueError(f'mesh shape {shape} and axis names {axis_names} '
                         f'differ in length')
    if int(np.prod(shape)) != count:
        raise ValueError(f'mesh shape {shape} needs {int(np.prod(shape))} '
                         f'ranks; the process group has {count}')
    group = (dist.group.WORLD
             if dist.is_available() and dist.is_initialized() else None)
    key = (shape, tuple(axis_names), count, id(group))
    if key not in _MESHES:
        groups = {name: _line_group(shape, [a], rank)
                  for a, name in enumerate(axis_names)}
        _MESHES[key] = Mesh(shape, axis_names, rank, groups)
    return _MESHES[key]


def _line_group(shape, axes, rank):
    """The group of the ranks that differ from ``rank`` only along the
    dims ``axes`` of the row-major grid ``shape`` (collective: every rank
    builds every such group). The whole world is the default group, even
    of one rank: a one-rank process group still runs its collectives."""
    count = int(np.prod(shape))
    size = int(np.prod([shape[a] for a in axes]))
    initialized = dist.is_available() and dist.is_initialized()
    if not initialized:
        return None
    if size == count:
        return dist.group.WORLD
    if size == 1:
        return None
    grid = np.moveaxis(np.arange(count).reshape(shape), axes,
                       range(-len(axes), 0))
    mine = None
    for line in grid.reshape(-1, size):
        group = dist.new_group([int(r) for r in line])
        if rank in line:
            mine = group
    return mine


###############################################################################
# Batches
###############################################################################


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *items)
                          for items in zip(tree, *rest))
    return fn(tree, *rest)


class Sharding(NamedTuple):
    """Where a batch lives on ``mesh``: its leading dim split over
    ``axis`` (each rank holds its block), or replicated (``axis`` None)."""
    mesh: Mesh
    axis: Optional[str]

    def block(self, x):
        """This rank's block of ``x``'s leading dim (numpy or tensor)."""
        if self.axis is None:
            return x
        n, i = self.mesh.shape.get(self.axis, 1), self.mesh.index(self.axis)
        if x.shape[0] % n:
            raise ValueError(
                f'batch dim {x.shape[0]} not divisible by mesh axis '
                f'{self.axis!r} ({n} ranks): pad with pad_batch_to_multiple')
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]


def batch_sharding(mesh: Mesh, axis: str = 'data') -> Sharding:
    """The leading (batch) dim split over ``axis``."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(mesh: Mesh, tree, axis: str = 'data'):
    """This rank's block of the leading dim of every array in ``tree``."""
    return tree_map(batch_sharding(mesh, axis).block, tree)


def replicate(mesh: Mesh, tree, device=None):
    """Rank 0's values of every array in ``tree`` as tensors on
    ``device`` (each rank's own tensor's device when None), on every rank:
    a broadcast over the mesh."""
    group = dist.group.WORLD if mesh.size > 1 else None

    def place(x):
        t = torch.as_tensor(x)
        t = t.to(device) if device is not None else t
        return comm.broadcast_(t.contiguous().clone(), group, 0,
                               'replicate')

    return tree_map(place, tree)


def gather_batch(tensor, mesh: Mesh, axis: str = 'data', dim: int = 0):
    """The blocks of ``axis``'s ranks joined along ``dim`` (no gradient):
    the inverse of ``shard_batch``."""
    group = mesh.group(axis)
    if group is None:
        return tensor
    return comm.gather_along(tensor.contiguous(), group, dim)


def pad_batch_to_multiple(arrays, batch_axis_size: int, fill=0):
    """Pad the leading dim of every array to a multiple of
    ``batch_axis_size`` (numpy in, numpy out).

    ``fill`` is a scalar or a tree matching ``arrays`` of pad values.
    Validity is -100-sentinel-based, not length-based (reference
    ppgs/data/collate.py:45-50): target arrays MUST be padded with -100 so
    that padded rows add zero valid frames to the loss and the metrics."""
    def pad(x, value):
        x = np.asarray(x)
        b = x.shape[0]
        target = -(-b // batch_axis_size) * batch_axis_size
        if target == b:
            return x
        widths = [(0, target - b)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths, constant_values=value)

    if not isinstance(fill, (tuple, list, dict)):
        fill = tree_map(lambda _: fill, arrays)
    return tree_map(pad, arrays, fill)


###############################################################################
# Tensor-parallel rules (the JAX package's, on JAX-layout parameter paths)
###############################################################################


def _paths(params):
    """{dotted path: array} of a flat or nested JAX-layout tree."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f'{prefix}{k}.')
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f'{prefix}{i}.')
        else:
            flat[prefix[:-1]] = node

    walk(params, '')
    return flat


def w2v2_dim(joined: str, ndim: int):
    """The w2v2 rule for one parameter path (``ppgs_tpu/parallel/
    __init__.py:58-94``, its substring matching kept): attention heads and
    the FFN hidden split, the feature convs' output channels; None:
    replicated."""
    if any(k in joined for k in ['wq', 'wk', 'wv']):
        return 1                                     # column-parallel
    if any(k in joined for k in ['bq', 'bk', 'bv']):
        return 0
    if 'wo' in joined:
        return 0                                     # row-parallel
    if joined.endswith('ffn.w1') or '.w1' in joined:
        return 1
    if joined.endswith('ffn.b1') or '.b1' in joined:
        return 0
    if joined.endswith('ffn.w2') or '.w2' in joined:
        return 0
    if 'feature_encoder' in joined and 'conv' in joined and ndim == 3:
        return 2                                     # (K, I, O)
    return None


def conformer_dim(joined: str, ndim: int):
    """The conformer rule for one parameter path (``ppgs_tpu/parallel/
    __init__.py:97-148``): attention heads, the FFN hidden and the conv
    module's channels split inside the blocks; None: replicated."""
    if 'blocks' not in joined:
        return None
    if any(f'attn.{k}.weight' in joined for k in ('q', 'k', 'v', 'pos')):
        return 1
    if any(f'attn.{k}.bias' in joined for k in ('q', 'k', 'v')):
        return 0
    if 'attn.out.weight' in joined:
        return 0
    if 'pos_bias' in joined:                          # (heads, d_head)
        return 0
    if '.w1.weight' in joined:
        return 1
    if '.w1.bias' in joined:
        return 0
    if '.w2.weight' in joined:
        return 0
    if 'pointwise1.weight' in joined:                 # (1, d, 2d)
        return 2
    if 'pointwise1.bias' in joined:
        return 0
    if 'depthwise.weight' in joined:                  # (k, 1, d)
        return 2
    if 'depthwise.bias' in joined or 'batch_norm' in joined:
        return 0
    if 'pointwise2.weight' in joined:                 # (1, d, d)
        return 1
    return None


def w2v2_param_sharding(mesh: Mesh, params, axis: str = 'model'):
    """{path: the dim that splits over ``axis``, or None} for a JAX-layout
    w2v2 parameter tree (flat or nested): JAX's NamedSharding rule, as the
    dim of its PartitionSpec that names the axis."""
    return {p: w2v2_dim(p, np.ndim(v)) for p, v in _paths(params).items()}


def conformer_param_sharding(mesh: Mesh, params, axis: str = 'model'):
    """{path: dim or None} for a JAX-layout conformer tree (flat or
    nested), by JAX's conformer rule."""
    return {p: conformer_dim(p, np.ndim(v))
            for p, v in _paths(params).items()}


def shard_params(params, shardings, mesh: Mesh, axis: str = 'model'):
    """This rank's slice of every parameter of a flat or nested tree along
    its dim in ``shardings`` (whole where the dim is None): the block that
    JAX's NamedSharding gives the device at this rank's coordinate."""
    n, i = mesh.shape.get(axis, 1), mesh.index(axis)
    out = {}
    for path, value in _paths(params).items():
        dim = shardings[path]
        if dim is None or n == 1:
            out[path] = value
            continue
        width = value.shape[dim] // n
        index = [slice(None)] * np.ndim(value)
        index[dim] = slice(i * width, (i + 1) * width)
        out[path] = value[tuple(index)]
    return out


###############################################################################
# Tensor parallelism on port modules
###############################################################################


def w2v2_module_dims(model) -> Dict[str, tuple]:
    """{tensor name: (dim, blocks)} of a ``models.w2v2.Wav2Vec2`` (or a
    ``models.transformer.Transformer``, whose layers are the same
    ``EncoderLayer``) under the w2v2 rule: each port tensor is translated
    to the JAX path it comes from (``convert.w2v2_params_from_jax``,
    ``convert.prepare_layers``, ``prepare_w2v2``) and that path's dim
    carried through the conversion. The fused q|k|v matrices split each of
    their 3 blocks alike."""
    dims = {}
    for name, tensor in _named_tensors(model):
        parts = name.split('.')
        leaf, jax_name, to_port = parts[-1], None, (lambda d: d)
        blocks = 1
        if 'layers' in parts and ('attn' in parts or 'prepared' in parts
                                  or 'ffn' in parts):
            stem = '.'.join(parts[:parts.index('layers') + 2])
            base = leaf.replace('_folded', '')
            if base in ('wqkv', 'bqkv'):
                jax_name, blocks = f'{stem}.attn.{base[0]}q', 3
            elif base in ('wo', 'bo'):
                jax_name = f'{stem}.attn.{base}'
            elif base in ('w1', 'b1', 'w2', 'b2'):
                jax_name = f'{stem}.ffn.{base}'
        elif 'feature_encoder' in parts and leaf == 'weight':
            jax_name = name                      # torch (O, I, K)
            to_port = (lambda d: 2 - d)
        elif 'feature_prepared' in parts:        # (k * I, O)
            jax_name = f'feature_encoder.{leaf[1:]}.conv.weight'
            to_port = (lambda d: 1 if d == 2 else d)
        dim = None if jax_name is None else w2v2_dim(
            jax_name, 3 if 'conv' in jax_name else tensor.ndim)
        if dim is not None:
            dims[name] = (to_port(dim), blocks)
    return dims


def conformer_module_dims(model) -> Dict[str, tuple]:
    """{tensor name: (dim, blocks)} of a ``models.conformer.Conformer``
    under the conformer rule. Its parameters keep the JAX layout and
    paths; each ``prepared`` copy (``convert.prepare_conformer``) is
    translated to the path it comes from."""
    sources = {'wqkv': ('attn.q.weight', 3, None),
               'bqkv': ('attn.q.bias', 3, None),
               'wpos': ('attn.pos.weight', 1, None),
               'pos_bias_u': ('attn.pos_bias_u', 1, None),
               'pos_bias_v': ('attn.pos_bias_v', 1, None),
               'wo': ('attn.out.weight', 1, None),
               'bo': ('attn.out.bias', 1, None),
               'pw1': ('conv.pointwise1.weight', 1, {2: 1}),
               'dw': ('conv.depthwise.weight', 1, {2: 0}),
               'pw2': ('conv.pointwise2.weight', 1, {1: 0})}
    dims = {}
    for name, tensor in _named_tensors(model):
        parts = name.split('.')
        if 'prepared' not in parts:
            dim, blocks = conformer_dim(name, tensor.ndim), 1
        elif parts[0] != 'blocks':
            dim = None
        else:
            stem = '.'.join(parts[:2])
            leaf = parts[-1]
            if parts[-2] in ('ff_macaron', 'ff'):
                source = (f'{parts[-2]}.{leaf}.weight' if leaf[0] == 'w'
                          else f'{parts[-2]}.w{leaf[1]}.bias')
                path, blocks, remap = source, 1, None
            else:
                path, blocks, remap = sources[leaf]
            dim = conformer_dim(f'{stem}.{path}', 0)
            if dim is not None and remap is not None:
                dim = remap[dim]
        if dim is not None:
            dims[name] = (dim, blocks)
    return dims


def _named_tensors(module):
    yield from module.named_parameters()
    yield from module.named_buffers()


def _owner(module, name):
    *path, leaf = name.split('.')
    for part in path:
        module = getattr(module, part)
    return module, leaf


@torch.no_grad()
def shard_module(model, dims, mesh: Mesh, axis: str = 'model'):
    """Keep this rank's slice of each tensor of ``model`` named in ``dims``
    ({name: (dim, blocks)}, from ``w2v2_module_dims`` or
    ``conformer_module_dims``), in place; returns the ``TPView`` that the
    model code runs on."""
    group = mesh.group(axis)
    for name, (dim, blocks) in dims.items():
        owner, leaf = _owner(model, name)
        tensor = getattr(owner, leaf)
        piece = comm.block_of(tensor.detach(), group, dim, blocks).clone()
        if isinstance(tensor, torch.nn.Parameter):
            setattr(owner, leaf, torch.nn.Parameter(
                piece, requires_grad=tensor.requires_grad))
        else:
            owner._buffers[leaf] = piece
    return TPView(model, dict(dims), group)


class TPView:
    """A module whose tensors in ``dims`` hold this rank's TP slices, as
    the model code reads it: a submodule reads as a view of itself, a
    sharded tensor as the whole tensor, all-gathered over ``group`` on
    first read and kept until the view is dropped. Iterating a layer list
    yields a fresh view a layer, so a layer's whole weights live while the
    loop body runs it. With a gradient the gather's backward is the
    reduce-scatter of the replicas' gradients, scaled by 1 / their count:
    each rank along the group runs the same rows through the same layer.
    Calling the view runs the module's ``forward`` on it."""

    def __init__(self, module, dims, group, prefix=''):
        object.__setattr__(self, '_module', module)
        object.__setattr__(self, '_dims', dims)
        object.__setattr__(self, '_group', group)
        object.__setattr__(self, '_prefix', prefix)
        object.__setattr__(self, '_cache', {})

    @property
    def module(self):
        return self._module

    def _child(self, name, value):
        return TPView(value, self._dims, self._group,
                      f'{self._prefix}{name}.')

    def __getattr__(self, name):
        cache = self._cache
        if name in cache:
            return cache[name]
        value = getattr(self._module, name)
        full = self._prefix + name
        if isinstance(value, torch.nn.Module):
            value = self._child(name, value)
        elif full in self._dims:
            value = self._gather(value, *self._dims[full])
        else:
            return value
        cache[name] = value
        return value

    def _gather(self, shard, dim, blocks):
        if torch.is_grad_enabled() and shard.requires_grad:
            n = comm.size(self._group)
            return comm.all_gather(comm.scale_grad(shard, 1.0 / n),
                                   self._group, dim, blocks, 'tp_gather')
        with torch.no_grad():
            comm._count('tp_gather', self._group)
            return comm.gather_along(shard.contiguous(), self._group, dim,
                                     blocks)

    def __iter__(self):
        for i, child in enumerate(self._module):
            yield self._child(str(i), child)

    def __getitem__(self, i):
        return self._child(str(i % len(self._module)), self._module[i])

    def __len__(self):
        return len(self._module)

    def __call__(self, *args, **kwargs):
        return type(self._module).forward(self, *args, **kwargs)

    def __setattr__(self, name, value):
        raise AttributeError(f'a TPView is read-only ({name})')


def local_bytes(module, names=None):
    """The bytes of ``module``'s parameters (those in ``names`` when given)
    that this rank holds."""
    return sum(p.numel() * p.element_size()
               for n, p in module.named_parameters()
               if names is None or n in names)


# (rule name, mesh shape, axis names, id(model), device) -> view or None
_FRONTEND_TP_CACHE = {}


def frontend_tp_placement(model, config, rule=None, device=None):
    """The TP placement of a frontend model (SURVEY §2.b item 3): when
    ``config``'s mesh has a > 1 'model' axis over several ranks, a
    ``Placement`` of ``model`` sharded by ``rule`` (default
    ``w2v2_module_dims``; ``conformer_module_dims`` for the conformer) and
    moved to ``device``, and the batch's sharding ('data' when that axis
    is > 1, else replicated). None on one rank or without a 'model' axis.

    ``model`` is the whole prepared model where it is cached (the host's
    copy, so that the card holds only the slices); it is copied, not
    changed. Placements are cached per (rule, mesh, model identity,
    device): the frontends hold their models in an lru_cache, so the
    sharding runs once."""
    if 'model' not in config.mesh_axis_names or world()[0] < 2:
        return None
    if rule is None:
        rule = w2v2_module_dims
    key = (rule.__name__, tuple(config.mesh_shape),
           tuple(config.mesh_axis_names), id(model), str(device))
    if key not in _FRONTEND_TP_CACHE:
        mesh = make_mesh(config.mesh_shape, config.mesh_axis_names)
        if mesh.shape.get('model', 1) <= 1:
            _FRONTEND_TP_CACHE[key] = None
        else:
            local = copy.deepcopy(model)
            view = shard_module(local, rule(local), mesh, 'model')
            local.to(device)
            sharding = (batch_sharding(mesh)
                        if mesh.shape.get('data', 1) > 1 else replicated(mesh))
            _FRONTEND_TP_CACHE[key] = Placement(view, sharding)
    return _FRONTEND_TP_CACHE[key]


class Placement(NamedTuple):
    """A frontend's TP view and its batch's sharding."""
    model: TPView
    sharding: Sharding

    def run(self, fn, *batch):
        """``fn(model, *rows)`` on this rank's rows of ``batch`` (all of
        them when the batch is replicated), the output's rows joined over
        the data axis."""
        rows = [self.sharding.block(x) for x in batch]
        out = fn(self.model, *rows)
        if self.sharding.axis is None:
            return out
        return gather_batch(out, self.sharding.mesh, self.sharding.axis)


from .context import (                                        # noqa: E402
    context_parallel_chunked_forward,
    pad_frames_for_context,
)
from .pipeline import (                                        # noqa: E402
    pipeline_forward,
    stack_layer_params,
)
from . import multihost                                        # noqa: E402
