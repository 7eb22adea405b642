"""Process groups, meshes, collectives and sharding rules.

Counterpart of ``vit_ocm_wmsegmentation_tpu/parallel/mesh.py``. The JAX
package drives every local chip from one process and lets GSPMD place the
collectives. Here each GPU is one process (``torchrun``), a :class:`Mesh`
lays the ranks out row-major over two named axes, ('data', 'model') or
('data', 'pipe'), as ``devices.reshape(data, model)`` lays out devices, and
the collectives are written out. This is the only module of the port that
calls ``torch.distributed``.

* There is no kernel-mesh context (``set_kernel_mesh``, ``dp_island``): each
  rank is its own island and runs the unchanged single-device kernels on its
  share of the rows. Only ``dp_island``'s padding rule stays: the leading
  axis is padded with zero rows to a multiple of the group size and sliced
  back after the gather (:func:`local_rows`, :func:`gather_rows`).
* A gloo group given tensors that lie on a card stages them through host
  memory. That is how two ranks share one GPU (NCCL refuses two ranks on one
  device). It is a stated mode of the mesh (:func:`staged_through_host`,
  printed by :func:`describe`), never taken for an NCCL group.
* The sharding rules name the parameters of the port's modules (timm/DINO
  keys): :func:`fsdp_param_sharding` is the JAX rule, :func:`vit_param_sharding`
  the Megatron split of the blocks over 'model'. :class:`ParamLayout` holds
  one rank's pieces and does a step's gradient reductions, the global norm
  and the gathers a checkpoint needs.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import re

import torch
import torch.distributed as dist
from torch import nn

DEFAULT_TIMEOUT_S = 300
# bytes of one flat all-reduce of a gradient bucket
BUCKET_BYTES = 25 * 2**20


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the default process group; returns (rank, world size).

    Without a world size, given or in torchrun's ``WORLD_SIZE``, this is a
    single-process run: returns (0, 1) and does nothing, as the JAX version
    does with no coordinator. When a group is already up it returns that
    group's rank and size. ``backend`` defaults to NCCL where CUDA is
    available, else gloo; ``init_method`` to ``env://`` (torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``; the tests pass ``file://`` stores).
    Before the group starts, the rank's current CUDA device is set: to
    ``device`` when given (two gloo ranks on one card pass ``cuda:0``), else,
    for NCCL, to torchrun's ``LOCAL_RANK``. Kernels launch on the current
    device (``build.stream_ptr`` checks it)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if world_size is None:
        if "WORLD_SIZE" not in env:
            return 0, 1
        world_size = int(env["WORLD_SIZE"])
    rank = int(env.get("RANK", 0)) if rank is None else rank
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    elif backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world_size


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def backend() -> str | None:
    return dist.get_backend() if is_distributed() else None


def shutdown():
    """Leave the default process group (a spawned rank's last call)."""
    if is_distributed():
        dist.destroy_process_group()


def is_main_process() -> bool:
    """Rank 0 owns logging, checkpoints and file output (the reference's
    rank gating, dino/utils.py:413-419)."""
    return not is_distributed() or dist.get_rank() == 0


def on_main_process(fn, *args, **kwargs):
    """save_on_master: run fn only on rank 0."""
    if is_main_process():
        return fn(*args, **kwargs)
    return None


def rank_device(kind: str = "cuda") -> torch.device:
    """This rank's device of ``kind``: the current CUDA device (set by
    :func:`init_distributed`) or the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The world's ranks laid out row-major over named axes: rank r sits at
    coordinates ``unravel(r, sizes)``. ``groups[i]`` is the process group of
    the ranks that differ from this one only along axis i (None without a
    process group: then every collective is the identity, and the rules
    below can be read for a mesh that was never started)."""

    axis_names: tuple
    sizes: tuple
    rank: int = 0
    backend: str | None = None
    groups: tuple = ()
    # per axis, the global ranks of this rank's group, in axis order
    members: tuple = ()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if axis not in self.axis_names:
            return 0
        i = self.axis_names.index(axis)
        return (self.rank // math.prod(self.sizes[i + 1:])) % self.sizes[i]

    def group(self, axis: str):
        if axis not in self.axis_names or not self.groups:
            return None
        return self.groups[self.axis_names.index(axis)]

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` in this rank's group."""
        return self.members[self.axis_names.index(axis)][index]

    def host_staged(self, t: torch.Tensor) -> bool:
        return staged_through_host(self.backend, t.device)


def staged_through_host(backend: str | None, device) -> bool:
    """gloo collectives on card tensors go through host copies."""
    return backend == "gloo" and torch.device(device).type == "cuda"


def _make(names, sizes) -> Mesh:
    world = dist.get_world_size() if is_distributed() else 1
    sizes = list(sizes)
    if sizes.count(-1) > 1:
        raise ValueError(f"at most one axis may be -1, got {dict(zip(names, sizes))}")
    if -1 in sizes:
        rest = math.prod(s for s in sizes if s != -1)
        if world % rest:
            raise ValueError(f"{dict(zip(names, sizes))} does not divide {world} ranks")
        sizes[sizes.index(-1)] = world // rest
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} ranks, "
                         f"the group has {world}")
    if not is_distributed():
        return Mesh(tuple(names), tuple(sizes))
    rank = dist.get_rank()
    grid = torch.arange(world).reshape(sizes)
    groups, members = [], []
    for i in range(len(sizes)):
        # every rank creates every group, in the same order (new_group's rule)
        lines = grid.movedim(i, -1).reshape(-1, sizes[i]).tolist()
        for line in lines:
            g = dist.new_group(line)
            if rank in line:
                groups.append(g)
                members.append(tuple(line))
    return Mesh(tuple(names), tuple(sizes), rank, dist.get_backend(), tuple(groups),
                tuple(members))


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """('data', 'model') mesh over the whole group; data=-1 takes the rest."""
    return _make(("data", "model"), (data, model))


def describe(mesh: Mesh, device) -> str:
    """One line naming the mesh, its backend, and host staging when a gloo
    group carries card tensors."""
    dev = torch.device(device)
    staged = (", card tensors staged through host memory"
              if staged_through_host(mesh.backend, dev) else "")
    return (f"mesh {mesh.shape} on {mesh.size} rank(s), backend {mesh.backend}, "
            f"device {dev}{staged}")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``axis``, in place; returns t."""
    g = mesh.group(axis)
    if g is None:
        return t
    if mesh.host_staged(t):
        h = t.cpu()
        dist.all_reduce(h, group=g)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=g)
    return t


def all_reduce_tensors(tensors, mesh: Mesh, axis: str):
    """Sum every tensor of the list over ``axis`` in place, as flat
    all-reduces of buckets of at most BUCKET_BYTES, one dtype a bucket."""
    if mesh.group(axis) is None:
        return tensors
    buckets = {}
    for t in tensors:
        key = (t.dtype, t.device)
        if not buckets.get(key) or sum(x.numel() * x.element_size()
                                       for x in buckets[key][-1]) >= BUCKET_BYTES:
            buckets.setdefault(key, []).append([])
        buckets[key][-1].append(t)
    for groups in buckets.values():
        for bucket in groups:
            flat = all_reduce(torch.cat([t.reshape(-1) for t in bucket]), mesh, axis)
            for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(piece.view_as(t))
    return tensors


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The pieces of ``axis``'s ranks concatenated along ``dim``, in rank
    order; every rank's piece has the same shape."""
    g = mesh.group(axis)
    if g is None:
        return t
    n = mesh.axis_size(axis)
    src = t.movedim(dim, 0).contiguous()
    staged = mesh.host_staged(src)
    x = src.cpu() if staged else src
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=g)
    if staged:
        out = out.to(t.device)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's piece (along ``dim``) of the sum of ``t`` over ``axis``
    (``t``'s size along ``dim`` divisible by the axis')."""
    g = mesh.group(axis)
    if g is None:
        return t
    n = mesh.axis_size(axis)
    src = t.movedim(dim, 0).contiguous()
    staged = mesh.host_staged(src)
    x = src.cpu() if staged else src
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=g)
    if staged:
        out = out.to(t.device)
    return out.movedim(0, dim).contiguous()


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str, src_index: int) -> torch.Tensor:
    """Overwrite ``t`` on every rank of ``axis`` with the rank at
    ``src_index``'s; returns t."""
    g = mesh.group(axis)
    if g is None:
        return t
    src = mesh.global_rank(axis, src_index)
    if mesh.host_staged(t):
        h = t.cpu()
        dist.broadcast(h, src=src, group=g)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=g)
    return t


class _Sent:
    """A send in flight; keeps its (host) buffer alive until :meth:`wait`."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self):
        self.work.wait()
        self.buf = None


def send(t: torch.Tensor, mesh: Mesh, axis: str, dst_index: int) -> _Sent:
    """Start sending ``t`` to the rank at ``dst_index`` along ``axis``."""
    buf = t.detach().cpu() if mesh.host_staged(t) else t.detach().contiguous()
    return _Sent(dist.isend(buf, dst=mesh.global_rank(axis, dst_index), group=mesh.group(axis)),
                 buf)


def recv(like: torch.Tensor, mesh: Mesh, axis: str, src_index: int) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape, dtype and device from the rank
    at ``src_index`` along ``axis``."""
    staged = mesh.host_staged(like)
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)
    dist.recv(buf, src=mesh.global_rank(axis, src_index), group=mesh.group(axis))
    return buf.to(like.device) if staged else buf


# ---------------------------------------------------------------------------
# tensor parallelism: the Megatron pair over 'model'
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over 'model'."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over 'model' forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """The 'model' axis as a block sees it (models.vit.block_forward_tp):
    :meth:`enter` before a column-split product, :meth:`exit` after a
    row-split one."""

    mesh: Mesh

    @property
    def size(self) -> int:
        return self.mesh.axis_size("model")

    def enter(self, x):
        return _CopyToModel.apply(x, self.mesh)

    def exit(self, y):
        return _ReduceFromModel.apply(y, self.mesh)


# ---------------------------------------------------------------------------
# rows: the batch and tile axis over 'data'
# ---------------------------------------------------------------------------


def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with zero rows appended up to a multiple of n (dp_island's rule:
    the padded rows' results are sliced off, their gradient is zero)."""
    b = x.shape[0]
    bp = -(-b // n) * n
    if bp == b:
        return x
    return torch.cat([x, x.new_zeros((bp - b,) + tuple(x.shape[1:]))])


def local_rows(x, mesh: Mesh, axis: str = "data", pad: bool = False):
    """This rank's contiguous block of x's leading axis over ``axis``
    (``batch_sharding``'s split). ``pad`` pads to a multiple of the axis
    first; without it an indivisible axis raises ValueError."""
    n, i = mesh.axis_size(axis), mesh.index(axis)
    if pad:
        x = pad_rows(torch.as_tensor(x), n)
    elif x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by the mesh's "
                         f"{axis!r} axis {n}")
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def gather_rows(local: torch.Tensor, mesh: Mesh, rows: int, axis: str = "data"):
    """Every rank's :func:`local_rows` (padded) gathered, cut to ``rows``."""
    return all_gather(local, mesh, axis)[:rows]


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Shard:
    """A tensor split in equal pieces over a mesh axis along ``dim``;
    ``groups`` > 1 splits each of ``groups`` equal blocks of the dimension
    (qkv's q, k and v rows, so that a rank keeps whole heads)."""

    axis: str
    dim: int
    groups: int = 1

    def local(self, t, mesh: Mesh):
        n, i = mesh.axis_size(self.axis), mesh.index(self.axis)
        u = t.unflatten(self.dim, (self.groups, -1))
        return u.chunk(n, self.dim + 1)[i].flatten(self.dim, self.dim + 1).contiguous()

    def full(self, t, mesh: Mesh):
        u = t.unflatten(self.dim, (self.groups, -1))
        return all_gather(u, mesh, self.axis, self.dim + 1).flatten(self.dim, self.dim + 1)

    def reduce(self, g, mesh: Mesh):
        """The sum over the axis of a full gradient, cut to this rank's piece."""
        u = g.unflatten(self.dim, (self.groups, -1))
        return reduce_scatter(u, mesh, self.axis, self.dim + 1).flatten(self.dim, self.dim + 1)


def _shape(t):
    return tuple(t.shape) if hasattr(t, "shape") else tuple(t)


def data_parallel_sharding(mesh: Mesh, named) -> dict:
    """Pure dp: every parameter replicated."""
    return {name: None for name, _ in named}


def fsdp_param_sharding(mesh: Mesh, named, min_shard: int = 4096) -> dict:
    """ZeRO-3/FSDP sharding over 'data', the JAX package's rule: a tensor
    shards its largest axis divisible by the 'data' size (ties to the last
    such axis), and stays replicated (None) when its shard would hold fewer
    than ``min_shard`` elements or no axis divides. At ViT-S geometry that
    shards every weight matrix and replicates every bias and LayerNorm
    vector. ``named``: (name, tensor or shape) pairs."""
    data = mesh.axis_size("data")

    def rule(shape):
        if data <= 1 or math.prod(shape) < min_shard * data:
            return None
        cands = [(d, i) for i, d in enumerate(shape) if d > 0 and d % data == 0]
        if not cands:
            return None
        return Shard("data", max(cands)[1])

    return {name: rule(_shape(t)) for name, t in named}


# the Megatron split of a block over 'model': qkv and fc1 split their output
# rows (qkv by head, within each of q, k and v), proj and fc2 their input
# columns, so each block needs one all-reduce after attention and one after
# the MLP (models.vit.block_forward_tp)
_TP_RULES = [
    (r"blocks\.\d+\.attn\.qkv\.(weight|bias)$", Shard("model", 0, 3)),
    (r"blocks\.\d+\.attn\.proj\.weight$", Shard("model", 1)),
    (r"blocks\.\d+\.mlp\.fc1\.(weight|bias)$", Shard("model", 0)),
    (r"blocks\.\d+\.mlp\.fc2\.weight$", Shard("model", 1)),
]


def vit_param_sharding(mesh: Mesh, module) -> dict:
    """The tp rules for a ViT or SimMIM module's parameters, replicated
    (None) elsewhere. Raises ValueError when the heads or the MLP width do
    not divide over 'model' (GSPMD splits any layout; a rank here keeps
    whole heads)."""
    cfg = module.cfg
    model = mesh.axis_size("model")
    if model > 1 and (cfg.num_heads % model or cfg.embed_dim * cfg.mlp_ratio % model):
        raise ValueError(f"{cfg.num_heads} heads (MLP width {cfg.embed_dim * cfg.mlp_ratio}) "
                         f"do not divide over the mesh's 'model' axis {model}")

    def rule(name):
        if model <= 1:
            return None
        for pat, spec in _TP_RULES:
            if re.search(pat, name):
                return spec
        return None

    return {name: rule(name) for name, _ in module.named_parameters()}


# ---------------------------------------------------------------------------
# one rank's parameters
# ---------------------------------------------------------------------------


def _set_param(model: nn.Module, name: str, value: torch.Tensor, requires_grad: bool):
    mod, _, attr = name.rpartition(".")
    setattr(model.get_submodule(mod), attr, nn.Parameter(value, requires_grad=requires_grad))


class ParamLayout:
    """How this rank holds each parameter of a module, with the collectives
    a step and a checkpoint need.

    * ``specs[name]``: a :class:`Shard` over 'data' (FSDP: gathered whole for
      the forward, its gradient reduce-scattered back), a :class:`Shard` over
      'model' (tp: the rank computes with its piece), or None (replicated);
    * ``stage[name]``: under pipeline parallelism, the 'pipe' index of the
      stage that holds the tensor (block parameters); other ranks keep an
      empty tensor in its place. Absent for tensors every stage holds;
    * ``grad_owner[name]``: under pipeline parallelism, the stage whose
      gradient of a tensor every stage holds is the one to keep (the
      embedding's is computed on stage 0 only, the decoder's identically on
      every stage); the others contribute zeros to the sum over 'pipe'.

    :meth:`shard_module` replaces the module's parameters by this rank's
    pieces in place; the optimizer is built after it, on those pieces."""

    def __init__(self, mesh: Mesh, model: nn.Module, specs: dict | None = None,
                 stage: dict | None = None, grad_owner: dict | None = None):
        self.mesh = mesh
        self.specs = {n: (specs or {}).get(n) for n, _ in model.named_parameters()}
        self.stage = stage or {}
        self.grad_owner = grad_owner or {}
        self.full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}

    @property
    def sharded(self) -> bool:
        """Whether this rank holds less than the whole module."""
        return bool(self.stage) or any(s is not None for s in self.specs.values())

    def held(self, name: str) -> bool:
        return self.stage.get(name, self.mesh.index("pipe")) == self.mesh.index("pipe")

    @torch.no_grad()
    def shard_module(self, model: nn.Module):
        for name, p in list(model.named_parameters()):
            spec = self.specs[name]
            if spec is not None:
                _set_param(model, name, spec.local(p.data, self.mesh), p.requires_grad)
            elif not self.held(name):
                _set_param(model, name, p.data.new_empty(0), False)
        return model

    def compute_params(self, model: nn.Module, names) -> dict:
        """{name: tensor the forward reads}: an FSDP piece gathered whole as
        a new leaf that requires a gradient, anything else the parameter
        itself."""
        params = dict(model.named_parameters())
        out = {}
        for n in names:
            spec, p = self.specs[n], params[n]
            if spec is not None and spec.axis == "data":
                out[n] = spec.full(p.detach(), self.mesh).requires_grad_()
            else:
                out[n] = p
        return out

    def reduce_grads(self, grads, names):
        """The gradients of the local loss (one per name, each the shape the
        forward read) -> this rank's share of the gradient of the global
        loss: stage-held tensors as they are over 'pipe', the others summed
        over 'pipe' from their owning stage; FSDP pieces reduce-scattered over
        'data', everything else summed over 'data'."""
        grads = list(grads)
        pipe = self.mesh.index("pipe")
        if self.mesh.axis_size("pipe") > 1:
            shared = [i for i, n in enumerate(names) if n not in self.stage]
            for i in shared:
                if self.grad_owner.get(names[i], pipe) != pipe:
                    grads[i] = torch.zeros_like(grads[i])
            all_reduce_tensors([grads[i] for i in shared], self.mesh, "pipe")
        plain = []
        for i, n in enumerate(names):
            spec = self.specs[n]
            if spec is not None and spec.axis == "data":
                grads[i] = spec.reduce(grads[i], self.mesh)
            else:
                plain.append(grads[i])
        all_reduce_tensors(plain, self.mesh, "data")
        return grads

    def norm_fn(self, names):
        """global_norm for gradients aligned with ``names`` as this rank holds
        them: the squares of distributed pieces (FSDP, tp, pipeline stages)
        summed over their axis once, replicated tensors counted once."""
        axes = []
        for n in names:
            spec = self.specs[n]
            axes.append(spec.axis if spec is not None else ("pipe" if n in self.stage else None))

        def norm(grads):
            sq = torch.stack(torch._foreach_norm([g.float() for g in grads])).square()
            total = sq.new_zeros(())
            for axis in ("data", "model", "pipe"):
                part = [sq[i] for i, a in enumerate(axes) if a == axis]
                if part:
                    total = total + all_reduce(torch.stack(part).sum(), self.mesh, axis)
            rest = [sq[i] for i, a in enumerate(axes) if a is None]
            if rest:
                total = total + torch.stack(rest).sum()
            return total.sqrt()

        return norm

    def full_tensor(self, name: str, local, like: torch.Tensor):
        """The whole tensor from this rank's piece (``local``; None where a
        pipeline stage does not hold it): gathered over the shard's axis or
        broadcast from the holding stage. ``like`` gives dtype and device."""
        spec = self.specs[name]
        if spec is not None:
            return spec.full(local, self.mesh)
        if name in self.stage:
            buf = local if self.held(name) else torch.zeros(
                self.full_shapes[name], dtype=like.dtype, device=like.device)
            return broadcast(buf.contiguous(), self.mesh, "pipe", self.stage[name])
        return local

    def local_tensor(self, name: str, full):
        """This rank's piece of a whole tensor (a rank holds every tensor it
        is asked for: its optimizer's)."""
        spec = self.specs[name]
        return spec.local(full, self.mesh) if spec is not None else full

    def full_state(self, model: nn.Module) -> dict:
        """The module's state dict in the plain single-device layout, on
        every rank (a collective: every rank calls it)."""
        return {n: self.full_tensor(n, p.detach(), p).detach()
                for n, p in model.named_parameters()}

    def full_optimizer_state(self, optimizer) -> dict:
        """``optimizer.state_dict()`` in the single-device layout (the
        parameter order of an Optimizer over the whole module), on every
        rank. Collective."""
        from ..train.optim import decay_names

        local = optimizer.state_dict()
        sd = local["opt"]
        by_name = {optimizer.names[i]: st for i, st in sd["state"].items()}
        decay, no_decay = decay_names(self.full_shapes.items())
        order = decay + no_decay
        # every rank has state once an update ran (each holds some tensors)
        keys = sorted({k for st in sd["state"].values() for k in st if k != "step"})
        like = next(p for p in optimizer.params)
        state = {}
        if keys:
            for j, name in enumerate(order):
                st = by_name.get(name, {})
                entry = {k: self.full_tensor(name, st.get(k), like) for k in keys}
                entry["step"] = torch.tensor(float(optimizer.updates))
                state[j] = entry
        groups = [dict(g) for g in sd["param_groups"]]
        groups[0]["params"] = list(range(len(decay)))
        groups[1]["params"] = list(range(len(decay), len(order)))
        return {"opt": {"state": state, "param_groups": groups}, "updates": local["updates"]}

    def load_full_optimizer_state(self, optimizer, plain: dict):
        """Load a :meth:`full_optimizer_state` (a single-device checkpoint's
        optimizer state) into this rank's optimizer, each tensor cut to the
        rank's piece."""
        from ..train.optim import decay_names

        decay, no_decay = decay_names(self.full_shapes.items())
        index = {n: j for j, n in enumerate(decay + no_decay)}
        full = plain["opt"]["state"]
        state = {}
        for i, name in enumerate(optimizer.names):
            st = full.get(index[name])
            if st is not None:
                state[i] = {k: (self.local_tensor(name, v) if k != "step" else v)
                            for k, v in st.items()}
        groups = optimizer.opt.state_dict()["param_groups"]
        optimizer.load_state_dict({"opt": {"state": state, "param_groups": groups},
                                   "updates": plain["updates"]})


def param_layout(mesh: Mesh, model: nn.Module, fsdp: bool = False,
                 min_shard: int = 4096) -> ParamLayout:
    """The layout of a ('data', 'model') mesh: FSDP over 'data'
    (:func:`fsdp_param_sharding`), else the Megatron split over a 'model'
    axis above 1 (:func:`vit_param_sharding`), else data parallel. FSDP with
    a 'model' axis raises ValueError (the JAX rule shards over 'data' only).
    Pipeline meshes take ``pp.pp_layout``."""
    if fsdp:
        if mesh.axis_size("model") > 1:
            raise ValueError(f"FSDP shards over 'data' and does not compose with a 'model' "
                             f"axis ({mesh.shape})")
        specs = fsdp_param_sharding(mesh, model.named_parameters(), min_shard)
    elif mesh.axis_size("model") > 1:
        specs = vit_param_sharding(mesh, model)
    else:
        specs = data_parallel_sharding(mesh, model.named_parameters())
    return ParamLayout(mesh, model, specs)


def bytes_at_rest(model: nn.Module, optimizer) -> int:
    """Bytes of the parameters and optimizer state tensors this rank holds."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    for st in optimizer.opt.state.values():
        n += sum(v.numel() * v.element_size() for v in st.values()
                 if torch.is_tensor(v) and v.dim() > 0)
    return n
