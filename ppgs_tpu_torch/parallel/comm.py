"""The collectives of the parallel layer, as explicit calls on a process
group.

The JAX package gets its collectives from sharding annotations (GSPMD) and
``jax.lax.ppermute`` inside ``shard_map``; here each one is a call on a
``torch.distributed`` group, and where a gradient flows through it, a
``torch.autograd.Function`` whose backward is the collective's transpose:

- ``all_gather``: backward ``reduce_scatter`` (the sum of the gathered
  gradients, this rank's block of it);
- ``ppermute``: the JAX primitive's semantics (pairs (source, destination)
  of indices along the group; a rank no pair sends to receives zeros),
  backward the inverse pairs: the backward of a send to the next rank is a
  receive from it;
- ``broadcast``: backward the sum of the gradients at the source.

``group`` is a process group, or None for one rank (every collective is
then the identity, and nothing is counted).

**Host staging on gloo.** gloo carries no point-to-point traffic and only
some collectives for CUDA tensors, so on a gloo group a CUDA tensor goes
through a host copy: the collective runs on the copy and the result comes
back to the device. Only the collective moves through the host; every
product still runs on the card. This is how two ranks share one card
(NCCL refuses two ranks on one device).

``counts`` counts the calls by (tag, backend): a train step's gradient
reduction is one ('gradients', 'nccl') on a card.
"""

import collections

import torch
import torch.distributed as dist

counts = collections.Counter()


def backend(group):
    """The group's backend name ('nccl', 'gloo'), or None for one rank."""
    return None if group is None else dist.get_backend(group)


def size(group):
    return 1 if group is None else dist.get_world_size(group)


def index(group):
    """This rank's index along ``group``."""
    return 0 if group is None else dist.get_rank(group)


def ranks(group):
    """The global ranks of ``group`` in index order."""
    return [0] if group is None else dist.get_process_group_ranks(group)


def _staged(tensor, group):
    """(the tensor the collective runs on, whether it is a host copy)."""
    if tensor.is_cuda and backend(group) == 'gloo':
        return tensor.detach().cpu(), True
    return tensor.contiguous(), False


def _count(tag, group):
    counts[(tag, backend(group))] += 1


###############################################################################
# Collectives without a gradient
###############################################################################


def all_reduce_sum(tensor, group, tag='all_reduce'):
    """The sum of ``tensor`` over ``group``, in place (returned)."""
    if group is None:
        return tensor
    _count(tag, group)
    work, staged = _staged(tensor, group)
    dist.all_reduce(work, op=dist.ReduceOp.SUM, group=group)
    if staged or work.data_ptr() != tensor.data_ptr():
        tensor.copy_(work)
    return tensor


def all_reduce_max(tensor, group, tag='all_reduce_max'):
    """The elementwise maximum of ``tensor`` over ``group``, in place."""
    if group is None:
        return tensor
    _count(tag, group)
    work, staged = _staged(tensor, group)
    dist.all_reduce(work, op=dist.ReduceOp.MAX, group=group)
    if staged or work.data_ptr() != tensor.data_ptr():
        tensor.copy_(work)
    return tensor


def broadcast_(tensor, group, source=0, tag='broadcast'):
    """``tensor`` of the rank at index ``source`` of ``group`` on every
    rank, in place."""
    if group is None:
        return tensor
    _count(tag, group)
    work, staged = _staged(tensor, group)
    dist.broadcast(work, src=ranks(group)[source], group=group)
    if staged or work.data_ptr() != tensor.data_ptr():
        tensor.copy_(work)
    return tensor


def _gather_list(tensor, group):
    work, staged = _staged(tensor, group)
    parts = [torch.empty_like(work) for _ in range(size(group))]
    dist.all_gather(parts, work, group=group)
    if staged:
        parts = [part.to(tensor.device) for part in parts]
    return parts


def _blocks(tensor, dim, blocks):
    """``tensor`` as ``blocks`` equal blocks along ``dim``: (..., blocks,
    size // blocks, ...)."""
    return tensor.unflatten(dim, (blocks, tensor.shape[dim] // blocks))


def gather_along(tensor, group, dim=0, blocks=1):
    """The tensors of ``group``'s ranks joined along ``dim``, in index
    order. ``blocks`` > 1: each rank holds its part of each of ``blocks``
    equal blocks of the whole (a fused q|k|v matrix whose q, k and v are
    split alike), and block b of the result is block b of every rank's,
    joined."""
    parts = _gather_list(tensor, group)
    if blocks == 1:
        return torch.cat(parts, dim=dim)
    dim = dim % tensor.ndim
    joined = torch.cat([_blocks(p, dim, blocks) for p in parts], dim=dim + 1)
    return joined.flatten(dim, dim + 1)


def block_of(tensor, group, dim=0, blocks=1):
    """This rank's part of ``tensor`` split over ``group`` along ``dim``
    (with ``blocks``: its part of each block): the inverse of
    ``gather_along``."""
    n, i = size(group), index(group)
    dim = dim % tensor.ndim
    if blocks == 1:
        return tensor.narrow(dim, i * (tensor.shape[dim] // n),
                             tensor.shape[dim] // n)
    split = _blocks(tensor, dim, blocks)
    width = split.shape[dim + 1] // n
    return split.narrow(dim + 1, i * width, width).flatten(dim, dim + 1)


def reduce_scatter(tensor, group, dim=0, blocks=1, tag='reduce_scatter'):
    """The sum of ``tensor`` over ``group``, this rank's block of it
    (``block_of``). One all-reduce, then the block: gloo has no
    reduce-scatter, and the product of the layer dominates."""
    total = all_reduce_sum(tensor.clone(), group, tag)
    return block_of(total, group, dim, blocks).contiguous()


###############################################################################
# Collectives with a gradient
###############################################################################


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, dim, blocks, tag):
        ctx.group, ctx.dim, ctx.blocks, ctx.tag = group, dim, blocks, tag
        _count(tag, group)
        return gather_along(tensor, group, dim, blocks)

    @staticmethod
    def backward(ctx, grad):
        return (reduce_scatter(grad, ctx.group, ctx.dim, ctx.blocks,
                               ctx.tag + '_backward'),
                None, None, None, None)


def all_gather(tensor, group, dim=0, blocks=1, tag='all_gather'):
    """``gather_along`` with a gradient: the backward is ``reduce_scatter``
    of the gradient over the group."""
    if group is None:
        return tensor
    return _AllGather.apply(tensor, group, dim, blocks, tag)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, scale):
        ctx.scale = scale
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def scale_grad(tensor, scale):
    """``tensor`` itself, its gradient times ``scale``."""
    return _ScaleGrad.apply(tensor, scale)


def _exchange(tensors, pairs, group, tag):
    """Send and receive every tensor along its pairs at once; (i, j) of
    ``pairs[k]``: index i sends ``tensors[k]`` to index j. A rank no pair
    sends to gets zeros. One tag a tensor, so that messages between the
    same two ranks pair up."""
    me, members = index(group), ranks(group)
    outs, ops, staged_back = [], [], []
    for k, (tensor, perm) in enumerate(zip(tensors, pairs)):
        out = torch.zeros_like(tensor)
        outs.append(out)
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(tensor)
            elif src == me:
                work, _ = _staged(tensor, group)
                ops.append(dist.isend(work, members[dst], group=group,
                                      tag=k))
                staged_back.append(work)        # alive until the wait
            elif dst == me:
                work, staged = _staged(out, group)
                ops.append(dist.irecv(work, members[src], group=group,
                                      tag=k))
                staged_back.append((out, work) if staged else work)
    _count(tag, group)
    for op in ops:
        op.wait()
    for item in staged_back:
        if isinstance(item, tuple):
            item[0].copy_(item[1])
    return outs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, pairs, tag, *tensors):
        ctx.group, ctx.pairs, ctx.tag = group, pairs, tag
        return tuple(_exchange(tensors, pairs, group, tag))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g.contiguous()
                 for g in grads]
        inverse = [[(dst, src) for src, dst in perm] for perm in ctx.pairs]
        back = _exchange(grads, inverse, ctx.group, ctx.tag + '_backward')
        return (None, None, None) + tuple(back)


def ppermute(tensors, pairs, group, tag='ppermute'):
    """``jax.lax.ppermute`` over ``group`` for several tensors in one
    exchange: ``pairs[k]`` lists the (source, destination) index pairs of
    ``tensors[k]``; returns the received tensors (zeros where no pair
    sends). Its backward sends each gradient along the inverse pairs, so
    the reverse schedule of a pipeline needs no code of its own. Every rank
    of the group calls it with the same pairs, in the same order."""
    tensors = [t.contiguous() for t in tensors]
    pairs = tuple(tuple(tuple(p) for p in perm) for perm in pairs)
    if group is None:
        return [t.clone() if (0, 0) in perm else torch.zeros_like(t)
                for t, perm in zip(tensors, pairs)]
    if not torch.is_grad_enabled() or not any(t.requires_grad
                                              for t in tensors):
        return _exchange(tensors, pairs, group, tag)
    return list(_PPermute.apply(group, pairs, tag, *tensors))


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, source, tag):
        ctx.group, ctx.source, ctx.tag = group, source, tag
        return broadcast_(tensor.detach().clone(), group, source, tag)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_sum(grad.contiguous().clone(), ctx.group,
                               ctx.tag + '_backward')
        if index(ctx.group) != ctx.source:
            total = torch.zeros_like(total)
        return total, None, None, None


def broadcast(tensor, group, source=0, tag='broadcast'):
    """The source rank's ``tensor`` on every rank of ``group``, with a
    gradient: the backward sums the ranks' gradients at the source (the
    others' inputs get zeros)."""
    if group is None:
        return tensor
    return _Broadcast.apply(tensor, group, source, tag)
