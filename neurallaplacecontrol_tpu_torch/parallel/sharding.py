"""Multi-device sharding over ``torch.distributed`` (port of ``parallel/sharding.py``).

One process drives one device, and the processes of a group meet only in
collectives. The JAX module's single-controller constructs map as follows:

- a ``Mesh`` of named axes is a grid of ranks; each axis of it has, on
  every rank, the process group of the ranks that differ from this one only
  along that axis (``Mesh.group``);
- ``shard_map`` with ``P(axis)`` over the K rollouts is each rank planning
  with its K/n block of the global noise draw, and ``pmin``/``psum`` are
  ``all_reduce`` MIN/SUM over the group (``planners.mppi_delay``);
- ``NamedSharding`` of the parameters is hand-split weights: the MLP stacks
  of a parameter tree alternate column- and row-parallel layers over "tp"
  (Megatron's rule, ``derive_param_pspecs``), and a split layer applies its
  own collectives (``TensorParallelLinear``).

Groups are made with ``new_group(..., use_local_synchronization=True)``:
only the member ranks take part, so the ranks of one host can build their
meshes while other hosts do other work (the driver's ``--multihost`` x
``--shard``). With no process group at all a process is a world of one:
every mesh is one rank, every group is None, and each function here is the
unsharded computation. Pipeline and expert parallelism are not meaningful
for these models (two-layer MLPs and GRUs, < 100k parameters).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.common import tree_leaves, tree_unflatten
from ..planners.mppi_delay import _sample_noise, mppi_command_core, shard_block
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

# groups made so far, by their sorted global ranks: a group is named after its
# ranks under local synchronization, so a rank set is made once per process
_GROUPS: dict = {}


def _group_of(ranks) -> Optional[dist.ProcessGroup]:
    """The process group of ``ranks`` (global ranks, this one among them);
    None without a process group (a world of one)."""
    if not dist.is_initialized():
        return None
    ranks = tuple(sorted(int(r) for r in ranks))
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks), use_local_synchronization=True)
    return _GROUPS[ranks]


def _this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """Ranks on a grid with named axes: ``devices`` [n_0, n_1, ...] holds the
    global ranks (one process per device) and ``axis_names`` names the axes.
    Every rank of the grid builds the same mesh; the calling rank must be on
    it. ``device`` is the torch device this rank computes on."""

    def __init__(self, devices, axis_names, device="cuda"):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes {self.axis_names}")
        if len(set(self.devices.ravel().tolist())) != self.devices.size:
            raise ValueError(f"a rank appears twice in the mesh {self.devices.tolist()}")
        if self.devices.max() >= _world_size():
            raise ValueError(f"mesh {self.devices.tolist()} names ranks beyond the world of {_world_size()}")
        where = np.argwhere(self.devices == _this_rank())
        if len(where) == 0:
            raise ValueError(f"rank {_this_rank()} is not on the mesh {self.devices.tolist()}")
        self.coord = {a: int(i) for a, i in zip(self.axis_names, where[0])}
        self.shape = {a: int(n) for a, n in zip(self.axis_names, self.devices.shape)}
        self.device = resolve_device(device)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: Optional[str] = None):
        """The process group along ``axis`` through this rank (every rank of
        the mesh for None); None without a process group."""
        if axis is None:
            return _group_of(self.devices.ravel())
        index = tuple(slice(None) if a == axis else self.coord[a] for a in self.axis_names)
        return _group_of(self.devices[index])


def make_mesh(n_devices: Optional[int] = None, tp: int = 2, device="cuda") -> Mesh:
    """A ("dp", "tp") mesh over the first ``n_devices`` ranks (every rank of
    the group by default): tp = min(tp, n), dp = n // tp, as the JAX
    function builds it."""
    n = n_devices or _world_size()
    tp = min(tp, n)
    dp = n // tp
    return Mesh(np.arange(dp * tp).reshape(dp, tp), ("dp", "tp"), device=device)


def _is_mlp_stack(node) -> bool:
    """A list of >= 2 linear-layer dicts ({"w": 2-D, "b": 1-D}): the shape
    ``models.common.mlp_init`` makes (NL's laplace_rep, NODE's ode_func)."""
    return (
        isinstance(node, (list, tuple))
        and len(node) >= 2
        and all(isinstance(el, dict) and set(el) == {"w", "b"} and el["w"].dim() == 2 for el in node)
    )


def derive_param_pspecs(params, tp_size: int = 2):
    """The JAX function's PartitionSpecs, each as the tuple of its axes: an
    MLP stack alternates column parallelism (even layers: w ``(None,
    "tp")``, b ``("tp",)``) and row parallelism (odd layers: w ``("tp",
    None)``, b ``()``) over "tp"; a layer whose split dimension does not
    divide ``tp_size`` stays replicated (``()``), and so does everything
    else: GRUs, scalars, embeddings. A tree without an MLP stack (rnn,
    delta_t_rnn) comes back replicated, data parallel only, with a log line."""

    def spec_for_stack(stack):
        out = []
        for i, layer in enumerate(stack):
            w = layer["w"]
            if i % 2 == 0 and w.shape[1] % tp_size == 0:
                out.append({"w": (None, "tp"), "b": ("tp",)})
            elif i % 2 == 1 and w.shape[0] % tp_size == 0:
                out.append({"w": ("tp", None), "b": ()})
            else:
                out.append({"w": (), "b": ()})
        return out

    found = [False]

    def walk(node):
        if _is_mlp_stack(node):
            found[0] = True
            return spec_for_stack(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return ()

    specs = walk(params)
    if not found[0]:
        logger.info("derive_param_pspecs: no MLP stack found; params fully replicated (dp-only training)")
    return specs


def nl_param_pspecs(params):
    """The NL tree's specs through the generic rule (laplace_rep is its one
    MLP stack; the encoder GRU stays replicated)."""
    return derive_param_pspecs(params)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduced gradient: the input of a column-parallel
    layer is whole on every rank, and each rank's gradient holds only its
    columns' share (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduced forward, identity gradient: the partial products of a
    row-parallel layer sum to its output, which every rank then uses whole
    (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    """The ranks' column blocks concatenated on the last dimension; the
    gradient is this rank's block of the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.block = (r * x.shape[-1], x.shape[-1])
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, *ctx.block).contiguous(), None


class TensorParallelLinear(dict):
    """One split linear layer of an MLP stack: its ``w`` and ``b`` are this
    rank's blocks, and ``models.common.linear_apply`` hands the layer's
    input to ``parallel_apply``. ``mode`` is "col" (output columns split:
    the input enters through ``enter``, and the output is gathered unless a
    row-parallel layer takes it split) or "row" (input rows split: the
    partial products are all-reduced, then the whole bias is added)."""

    def __init__(self, layer: dict, mode: str, group, gather_output: bool = False, split_input: bool = False):
        super().__init__(layer)
        self.mode, self.group = mode, group
        self.gather_output, self.split_input = gather_output, split_input

    def rewrap(self, layer: dict) -> "TensorParallelLinear":
        """The same placement around other tensors (after an update)."""
        return TensorParallelLinear(layer, self.mode, self.group, self.gather_output, self.split_input)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The whole input of a column-parallel layer, for a caller that
        multiplies by ``w`` itself (``models.node``)."""
        return _CopyToGroup.apply(x, self.group) if self.mode == "col" else x

    def parallel_apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "col":
            y = torch.matmul(_CopyToGroup.apply(x, self.group), self["w"]) + self["b"]
            return _GatherLast.apply(y, self.group) if self.gather_output else y
        if self.split_input:
            h = self["w"].shape[0]
            x = _CopyToGroup.apply(x, self.group).narrow(-1, dist.get_rank(self.group) * h, h)
        return _ReduceFromGroup.apply(torch.matmul(x, self["w"]), self.group) + self["b"]


def _shard_dim(spec) -> Optional[int]:
    return spec.index("tp") if "tp" in spec else None


def shard_params(params, mesh: Mesh):
    """This rank's parameters on the mesh: the blocks of the layers that
    ``derive_param_pspecs`` splits over "tp", as ``TensorParallelLinear``
    layers, and everything else whole. A mesh without a "tp" axis of more
    than one rank leaves the tree as it is."""
    tp = mesh.shape.get("tp", 1)
    if tp == 1:
        return params
    group, r = mesh.group("tp"), mesh.coord["tp"]
    specs = derive_param_pspecs(params, tp_size=tp)

    def block(x, spec):
        d = _shard_dim(spec)
        if d is None:
            return x
        n = x.shape[d] // tp
        return x.narrow(d, r * n, n).clone()

    def walk(node, spec):
        if _is_mlp_stack(node):
            modes = ["col" if "tp" in s["b"] else "row" if "tp" in s["w"] else None for s in spec]
            out = []
            for i, (layer, s, mode) in enumerate(zip(node, spec, modes)):
                local = {k: block(v, s[k]) for k, v in layer.items()}
                if mode is None:
                    out.append(local)
                    continue
                nxt = modes[i + 1] if i + 1 < len(modes) else None
                prev = modes[i - 1] if i > 0 else None
                out.append(TensorParallelLinear(local, mode, group, gather_output=nxt != "row",
                                                split_input=prev != "col"))
            return out
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, s) for v, s in zip(node, spec)]
        return node

    return walk(params, specs)


def _leaf_shard_dims(params) -> list:
    """Per leaf of ``params`` (``tree_leaves`` order): the dimension split
    over "tp", or None."""
    dims = []

    def walk(node):
        if isinstance(node, TensorParallelLinear):
            col = node.mode == "col"
            dims.extend((0 if col else None) if k == "b" else (1 if col else 0) for k in sorted(node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            dims.append(None)

    walk(params)
    return dims


def _rewrap(like, tree):
    """``tree`` (plain dicts and lists shaped like ``like``) with the
    placements of ``like``'s split layers."""
    if isinstance(like, TensorParallelLinear):
        return like.rewrap(tree)
    if isinstance(like, dict):
        return {k: _rewrap(like[k], tree[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return [_rewrap(a, b) for a, b in zip(like, tree)]
    return tree


def unshard_params(params, mesh: Mesh):
    """The whole parameter tree from this rank's blocks (``shard_params``'s
    inverse), gathered over "tp"; plain dicts and lists."""
    leaves = _gather_leaves(tree_leaves(params), _leaf_shard_dims(params), mesh)
    return tree_unflatten(params, leaves)


def _gather_leaves(leaves, dims, mesh: Mesh) -> list:
    if not any(d is not None for d in dims):
        return list(leaves)
    group, tp = mesh.group("tp"), mesh.shape["tp"]
    out = []
    for x, d in zip(leaves, dims):
        if d is None:
            out.append(x)
            continue
        parts = [torch.empty_like(x) for _ in range(tp)]
        dist.all_gather(parts, x.contiguous(), group=group)
        out.append(torch.cat(parts, dim=d))
    return out


def _local_leaves(leaves, dims, mesh: Mesh) -> list:
    if not any(d is not None for d in dims):
        return list(leaves)
    r, tp = mesh.coord["tp"], mesh.shape["tp"]
    return [x if d is None else x.narrow(d, r * (x.shape[d] // tp), x.shape[d] // tp).clone()
            for x, d in zip(leaves, dims)]


def make_sharded_train_step(model_apply: Callable, optimizer, mesh: Mesh):
    """The dp x tp training step: ``step(params, opt_state, s0, a0, sn, ts)
    -> (params, opt_state, loss)``, with ``params`` and ``opt_state`` this
    rank's (``shard_params`` and ``optimizer.init`` of its result) and the
    batch whole on every rank.

    The batch splits over "dp" into contiguous blocks. Each rank takes the
    loss ``mean((pred - (sn - s0))**2)`` of its block over dp (the mean over
    the whole batch, summed over dp), and the gradients are summed over dp;
    the split layers all-reduce their activations over "tp". The optimizer
    runs on the whole tree, gathered over "tp" and then split again: its
    global-norm clip needs every gradient, and the trees are small. The loss
    returned is the whole batch's on every rank."""
    dp_group = mesh.group("dp") if "dp" in mesh.shape else None
    dp = mesh.shape.get("dp", 1)
    r_dp = mesh.coord.get("dp", 0)

    def step(params, opt_state, s0, a0, sn, ts):
        B = s0.shape[0]
        if B % dp:
            raise ValueError(f"batch {B} does not split over dp={dp}")
        rows = slice(r_dp * (B // dp), (r_dp + 1) * (B // dp))
        dims = _leaf_shard_dims(params)
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        p = _rewrap(params, tree_unflatten(params, leaves))
        pred = model_apply(p, s0[rows], a0[rows], ts[rows])
        loss = torch.mean((pred - (sn[rows] - s0[rows])) ** 2) / dp
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        if dp_group is not None:
            flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=dp_group)
            loss, offset = flat[0], 1
            for i, g in enumerate(grads):
                grads[i] = flat[offset : offset + g.numel()].reshape(g.shape)
                offset += g.numel()
        whole = tree_unflatten(params, _gather_leaves([x.detach() for x in leaves], dims, mesh))
        g_whole = tree_unflatten(params, _gather_leaves(grads, dims, mesh))
        state_whole = _map_param_trees(opt_state, params, lambda t: tree_unflatten(
            params, _gather_leaves(tree_leaves(t), dims, mesh)))
        updates, state_whole = optimizer.update(g_whole, state_whole, whole)
        new = [p_ + u for p_, u in zip(leaves, _local_leaves(tree_leaves(updates), dims, mesh))]
        opt_state = _map_param_trees(state_whole, params, lambda t: tree_unflatten(
            params, _local_leaves(tree_leaves(t), dims, mesh)), shapes=False)
        return _rewrap(params, tree_unflatten(params, [x.detach() for x in new])), opt_state, loss

    return step


def _map_param_trees(state, params, fn, shapes: bool = True):
    """``fn`` over the fields of an optimizer state (a NamedTuple) that are
    trees like ``params`` (Adam's moments); other fields pass unchanged.
    With ``shapes`` a field must also match the params' leaf shapes."""
    n = len(tree_leaves(params))
    local = [x.shape for x in tree_leaves(params)]

    def like(field):
        if not isinstance(field, (dict, list, tuple)) or len(tree_leaves(field)) != n:
            return False
        return not shapes or [x.shape for x in tree_leaves(field)] == local

    return type(state)(*(fn(f) if like(f) else f for f in state))


def _k_sharded_command(cfg, params, dynamics_fn, running_cost_fn, group, **core_kw):
    """``command(U, obs, action_buffer, generator=None, noise=None,
    time_buffer=None, cost_args=())`` planning this rank's block of the
    global noise draw, the reductions over ``group`` (None: the whole K)."""
    if group is not None and cfg.num_samples % dist.get_world_size(group):
        raise ValueError(f"the {dist.get_world_size(group)} ranks of the k axis must divide "
                         f"K={cfg.num_samples} (num_samples)")

    def command(U, obs, action_buffer, generator=None, noise=None, time_buffer=None, cost_args=()):
        if noise is None:
            noise = _sample_noise(generator, cfg, params)
        if group is not None:
            noise = shard_block(noise, group)
        U = torch.roll(U, -1, dims=-2)
        U[..., -1, :] = params.u_init
        return mppi_command_core(cfg, params, dynamics_fn, running_cost_fn, U, obs, action_buffer, noise,
                                 time_buffer=time_buffer, cost_args=cost_args, axis=group, **core_kw)

    return command


def make_k_sharded_mppi_command(
    cfg,
    params,
    dynamics_fn,
    running_cost_fn,
    mesh: Mesh,
    terminal_state_cost=None,
    dynamics_carry_init=None,
    window_encoder=None,
):
    """MPPI command with the K rollouts split over every rank of ``mesh``.

    Each rank runs ``planners.mppi_delay.mppi_command_core`` on its K/n block
    of the global noise draw with ``axis`` set to the mesh's group, so every
    planner flag behaves as in one process, and the plan is the one-process
    plan up to the rounding of the three reductions. Returned:
    ``command(U, obs, action_buffer, generator=None, noise=None,
    time_buffer=None, cost_args=()) -> (action, U_new, aux)``, the signature
    of ``mppi_command``: ``noise`` is the global [(S,) K, T, nu] draw (the
    same on every rank), or one plan's draw comes from ``generator``; aux
    holds this rank's rows."""
    return _k_sharded_command(cfg, params, dynamics_fn, running_cost_fn, mesh.group(),
                              terminal_state_cost=terminal_state_cost, dynamics_carry_init=dynamics_carry_init,
                              window_encoder=window_encoder)


def gather_seeds(x: torch.Tensor, index: range, n_seeds: int, owner: bool, group) -> torch.Tensor:
    """Per-seed results [len(index), ...] of this rank into the whole [S,
    ...] on every rank of ``group``: zeros but this rank's seeds where it
    owns them, summed over the group (exact, and an ``all_reduce``, which
    gloo also runs on CUDA tensors)."""
    if group is None:
        return x
    out = x.new_zeros((n_seeds,) + tuple(x.shape[1:]))
    if owner:
        out[index.start : index.stop] = x
    dist.all_reduce(out, group=group)
    return out


def make_grid_sharded_episodes(
    env,
    dynamics_fn,
    mppi_cfg,
    mppi_params,
    settings,
    mesh: Mesh,
    terminal_state_cost=None,
    dynamics_carry_init=None,
):
    """Control episodes on a 2-D ("seeds", "k") mesh: the seeds split over
    "seeds" in contiguous blocks, and each episode's K rollouts over "k".

    Every rank runs the episodes of its seed block in lockstep, with the
    K-sharded planner on its k-block of each step's global noise draw; the
    planner's reductions run over "k" only, so the ranks of one k-group
    keep identical copies of their seeds' episodes. Returns
    ``episodes(draws) -> (totals [S], records)``, ``draws`` a
    ``training.rollout.SeedDraws`` (or a stand-in with its ``select``) for
    all S seeds; the results of every seed are gathered on every rank."""
    from ..training.rollout import EpisodeRecords, build_goal_running_cost, build_running_cost, make_episode_fn

    if set(mesh.axis_names) != {"seeds", "k"}:
        raise ValueError(f"the grid mesh's axes are ('seeds', 'k'), not {mesh.axis_names}")
    n_s = mesh.shape["seeds"]
    all_group = mesh.group()
    cost_fn = (build_goal_running_cost(env) if settings.change_goal
               else build_running_cost(env, state_constraint=settings.state_constraint))
    command = _k_sharded_command(mppi_cfg, mppi_params, dynamics_fn, cost_fn, mesh.group("k"),
                                 terminal_state_cost=terminal_state_cost, dynamics_carry_init=dynamics_carry_init)
    episode = make_episode_fn(env, dynamics_fn, mppi_cfg, mppi_params, settings,
                              dynamics_carry_init=dynamics_carry_init, command_fn=command, vary_axis="seeds")

    def episodes(draws):
        S = len(draws)
        if S % n_s:
            raise ValueError(f"{S} seeds do not split over the seeds axis ({n_s})")
        i = mesh.coord["seeds"]
        index = range(i * (S // n_s), (i + 1) * (S // n_s))
        totals, records = episode(draws.select(index))
        owner = mesh.coord["k"] == 0
        totals = gather_seeds(totals, index, S, owner, all_group)
        records = EpisodeRecords(*(gather_seeds(x, index, S, owner, all_group) for x in records))
        return totals, records

    return episodes
