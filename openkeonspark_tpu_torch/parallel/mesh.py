"""The (data, model) and (host, data, model) grids over
``torch.distributed``, the tables' row layouts on them, and the
collectives the sharded steps use.

Counterpart of ``openkeonspark_tpu/parallel/mesh.py``. The JAX package's
``Mesh`` with axes ``('data', 'model')`` becomes a :class:`Grid` of
``data × model`` processes, one device each, laid out data-major: rank
``n = d·M + m`` sits in data row ``d`` and model column ``m``. A
collective over the JAX axis ``'model'`` runs over the rank's data row
(the M ranks that share a batch), one over ``'data'`` over its model
column (the D ranks that own the same rows in the psum layout), one over
both axes over the whole grid. Every row and column group is made with
``new_group`` by every rank in one order; a group of one rank makes no
collective at all, so a (1, 1) grid needs no process group and computes
what one device computes.

A ``(host, data, model)`` grid (``make_mesh((H, Di, M))``, the
hierarchical step's, ``parallel/hier.py``) numbers its ranks host-major,
``n = h·L + d·M + m`` with ``L = Di·M`` ranks a host: exactly the rank
order of the flat ``(H·Di, M)`` grid. So :class:`Grid` keeps that flat
view (``data = H·Di``, data row ``n // M``, the batch of the flat grid's
row) and adds ``hosts``, with two more groups: ``'local'``, the L ranks
of one host (the JAX axes ``('data', 'model')`` of ``hier.py:84``), and
``'host'``, the H ranks at one local position (the JAX axis
``'host'``). On one machine the "hosts" are groups of ranks; the backend
picks the links (NVLink inside a node, the network between nodes), so
nothing here prices them.

The backend is the caller's: ``nccl`` for a card per rank, ``gloo`` for
the CPU (and for ranks that share one card, which NCCL refuses).
``cli/launch.py`` initialises the process group; nothing here picks
another backend when the first fails. Payloads of ``all_to_all`` and
``all_gather`` travel as raw bytes (``uint8`` views), so a backend never
sees a type it refuses (gloo takes no ``float8_e4m3fn`` and no int16);
reductions run in the tensor's own dtype.

Layouts (:class:`Sharding`, the counterpart of ``table_spec``,
``mesh.py:81-91``): ``flat=False`` shards rows over ``'model'``
(replicated over ``'data'``, the psum step's layout), ``flat=True`` over
the whole grid (the exchange steps'); either way a rank holds contiguous
rows ``[i·Lp, (i+1)·Lp)``, ``Lp = rows / parts``, of every table and
optimizer slot, and nothing else (:func:`shard_state`,
``mesh.py:103-124``). The replicated ``#hot`` companions of hot-row
replication (``parallel/hot.py``) are the exception: every rank holds
all K rows of each, and a layout neither shards nor gathers them
(``mesh.py:109-117``). The sampler's triple store is replicated: every
rank builds the same sampler on its device (``shard_sampler``,
``:127-138``, has no counterpart)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA, MODEL = "data", "model"
LOCAL, HOST = "local", "host"   # a (host, data, model) grid's extra groups
HOT_SUFFIX = "#hot"             # a replicated companion's key suffix

# all_gather into one tensor (torch renamed it; the old name stays)
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


def hier_shape(mesh_shape: Tuple[int, int],
               chips_per_host: Optional[int]) -> Optional[Tuple[int, int,
                                                                int]]:
    """(host, data, model) factorisation of a (data, model) grid that spans
    hosts of ``chips_per_host`` devices, or None when it fits one host or
    does not factor (``mesh.py:63-78``). Such a grid runs the hierarchical
    step (``parallel/hier.py``)."""
    d, m = mesh_shape
    n = d * m
    if not chips_per_host or chips_per_host <= 0 or n <= chips_per_host:
        return None
    if chips_per_host % m or n % chips_per_host:
        return None
    return (n // chips_per_host, chips_per_host // m, m)


@dataclass
class Grid:
    """This process's place on the grid and its groups. ``data`` counts
    every data row of the grid (``H·Di`` on a (host, data, model) grid);
    ``hosts`` is H there, None on a (data, model) grid."""

    data: int
    model: int
    rank: int                      # n = d·M + m (= h·L + d_local·M + m)
    device: torch.device
    backend: Optional[str] = None  # None: one rank, no process group
    groups: Dict[str, object] = field(default_factory=dict)
    hosts: Optional[int] = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def d_idx(self) -> int:
        return self.rank // self.model

    @property
    def m_idx(self) -> int:
        return self.rank % self.model

    @property
    def local(self) -> int:
        """Ranks a host (L = Di·M; the whole grid on a (data, model)
        grid)."""
        return self.size // (self.hosts or 1)

    def axis_size(self, axis: str) -> int:
        return {DATA: self.data, MODEL: self.model, LOCAL: self.local,
                HOST: self.hosts or 1}.get(axis, self.size)

    def group(self, axis: str):
        """The process group of ``axis``: ``'model'`` (this data row),
        ``'data'`` (this model column), ``'local'`` (this host's ranks),
        ``'host'`` (this local position on every host) or ``'grid'``
        (every rank)."""
        return self.groups.get(axis)


def make_mesh(shape: Tuple[int, ...], device: torch.device) -> Grid:
    """The grid of ``shape = (data, model)``, or ``(host, data, model)``,
    over the initialised default process group (``shape[0] == -1``: every
    remaining rank), with this process's rank; a (1, 1) grid needs
    none."""
    hier = len(shape) == 3
    if not dist.is_initialized():
        if not hier and shape[0] in (1, -1) and shape[1] == 1:
            return Grid(1, 1, 0, device)
        raise RuntimeError(f"a {shape} grid needs an initialised process "
                           "group (cli/launch.py, or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    rest = 1
    for s in shape[1:]:
        rest *= s
    shape = ((max(1, world // max(rest, 1)) if shape[0] == -1 else shape[0]),
             *shape[1:])
    if shape[0] * rest != world:
        raise ValueError(f"grid {shape} needs {shape[0] * rest} ranks, the "
                         f"process group has {world}")
    hosts = shape[0] if hier else None
    d, m = (shape[0] * shape[1], shape[2]) if hier else shape
    grid = Grid(d, m, dist.get_rank(), device, dist.get_backend(),
                hosts=hosts)
    n_loc = grid.local
    # every rank creates every group, in one order (new_group's contract)
    axes = [(MODEL, [[r * m + c for c in range(m)] for r in range(d)]),
            (DATA, [[r * m + c for r in range(d)] for c in range(m)])]
    if hier:
        axes += [(LOCAL, [[h * n_loc + i for i in range(n_loc)]
                          for h in range(hosts)]),
                 (HOST, [[h * n_loc + i for h in range(hosts)]
                         for i in range(n_loc)])]
    for axis, members in axes:
        if len(members[0]) == 1:
            continue
        for ranks in members:
            g = dist.new_group(ranks)
            if grid.rank in ranks:
                grid.groups[axis] = g
    if world > 1:
        grid.groups["grid"] = dist.group.WORLD
    return grid


# ---- collectives ---------------------------------------------------------

def all_reduce(x: torch.Tensor, grid: Grid, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over ``axis`` in its dtype (``psum``); returns a new
    tensor, ``x`` itself when the axis has one rank."""
    if grid.axis_size(axis) == 1:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=grid.group(axis))
    return out


def all_gather(x: torch.Tensor, grid: Grid, axis: str) -> torch.Tensor:
    """``x`` of every rank of ``axis`` stacked along dim 0 in rank order
    (``all_gather(..., tiled=True)``); the payload travels as raw
    bytes."""
    n = grid.axis_size(axis)
    if n == 1:
        return x
    x = x.detach().contiguous()
    raw = x.view(-1).view(torch.uint8)
    if grid.backend == "gloo":
        # gloo gathers a list of tensors on every torch version, CUDA
        # tensors included
        parts = [torch.empty_like(raw) for _ in range(n)]
        dist.all_gather(parts, raw, group=grid.group(axis))
        out = torch.cat(parts)
    else:
        out = raw.new_empty(n * raw.numel())
        _all_gather_single(out, raw, group=grid.group(axis))
    return out.view(x.dtype).view((n * x.shape[0],) + tuple(x.shape[1:]))


def all_to_all(x: torch.Tensor, grid: Grid, axis: str = "grid"
               ) -> torch.Tensor:
    """``x`` [n·c, …]: block j goes to rank j of ``axis``, block j of the
    result came from rank j (``all_to_all(split_axis=0,
    concat_axis=0)``). The payload travels as raw bytes."""
    if grid.axis_size(axis) == 1:
        return x
    x = x.detach().contiguous()
    raw = x.view(-1).view(torch.uint8)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=grid.group(axis))
    return out.view(x.dtype).view(x.shape)


# ---- layouts -------------------------------------------------------------

@dataclass
class Sharding:
    """A row layout of the tables on ``grid``: over the whole grid
    (``flat``) or over ``'model'`` only."""

    grid: Grid
    flat: bool

    @property
    def axis(self) -> str:
        return "grid" if self.flat else MODEL

    @property
    def parts(self) -> int:
        return self.grid.size if self.flat else self.grid.model

    @property
    def index(self) -> int:
        return self.grid.rank if self.flat else self.grid.m_idx

    def rows(self, total: int) -> Tuple[int, int]:
        """(first row, row count) this rank holds of a ``total``-row
        table."""
        if total % self.parts:
            raise ValueError(f"{total} rows do not divide over "
                             f"{self.parts} shards; pad the tables to a "
                             "multiple of the grid size")
        lp = total // self.parts
        return self.index * lp, lp

    def shard(self, tree: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """This rank's rows of every table of a full (replicated) dict;
        ``#hot`` companions stay whole."""
        out = {}
        for k, v in tree.items():
            if k.endswith(HOT_SUFFIX):
                out[k] = v.clone()
                continue
            start, lp = self.rows(v.shape[0])
            out[k] = v[start:start + lp].clone()
        return out

    def gather(self, tree: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The full tables from every rank's rows (a collective: every
        rank calls it, every rank gets them); ``#hot`` companions are this
        rank's replica."""
        return {k: v if k.endswith(HOT_SUFFIX)
                else all_gather(v, self.grid, self.axis)
                for k, v in tree.items()}


def shard_state(state, grid: Grid, flat: bool = False):
    """Each rank keeps only its rows of every table and optimizer slot
    (and the whole of every ``#hot`` companion); the step counter is
    shared. Table rows must divide over the layout's parts (pad to the
    grid size, which suits both)."""
    sh = Sharding(grid, flat)
    return type(state)(params=sh.shard(state.params),
                       opt_state={s: sh.shard(v)
                                  for s, v in state.opt_state.items()},
                       step=state.step)


def unshard_state(state, sharding: Sharding):
    """The full state from every rank's rows (a collective)."""
    return type(state)(params=sharding.gather(state.params),
                       opt_state={s: sharding.gather(v)
                                  for s, v in state.opt_state.items()},
                       step=state.step)

