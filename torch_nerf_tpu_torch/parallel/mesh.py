"""The process mesh and the layout of the train state over it.

Counterpart of ``torch_nerf_tpu/parallel/mesh.py:42-147`` on
``torch.distributed``, one process per rank. A :class:`Mesh` is ``data x
model`` ranks, rank ``r`` at ``(r // model, r % model)``, as JAX reshapes
its device list: the ``data`` group of a rank holds the ranks of its model
index (rays, or scenes, shard over it), its ``model`` group the ranks of its
data index (the MLP's width shards over it).

The layout is the Megatron one of :func:`nerf_param_spec`: the classic
MLP's trunk alternates column-parallel (``fc_in, fc_2, fc_4, fc_6``: the
output features sharded) and row-parallel (``fc_1, fc_3, fc_5, fc_7``: the
input features sharded) layers; a layer whose dimension does not divide
the model size, and every leaf that is not a linear layer's (the
Instant-NGP tables and small MLPs), stays replicated. :func:`place_state`
puts a whole train state onto the mesh, :func:`gather_state` takes it back
whole for a checkpoint.

The backend is explicit: ``nccl`` on a CUDA device, ``gloo`` on the CPU by
default. NCCL refuses two ranks on one device, so :func:`check_backend`
raises for that, naming ``gloo``; nothing switches backend silently.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from torch_nerf_tpu_torch import train
from torch_nerf_tpu_torch.device import resolve_device
from torch_nerf_tpu_torch.models.nerf import params_from_jax
from torch_nerf_tpu_torch.parallel import collectives

COLUMN_PARALLEL = ("fc_in", "fc_2", "fc_4", "fc_6")
ROW_PARALLEL = ("fc_1", "fc_3", "fc_5", "fc_7")
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a ``data x model`` mesh of ranks, its process
    groups and its device."""

    rank: int
    world_size: int
    data_size: int
    model_size: int
    data_group: Any
    model_group: Any
    device: torch.device
    backend: str

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    def axis(self, name: str) -> Tuple[Any, int, int]:
        """``(group, rank within it, its size)`` of the ``"data"`` or
        ``"model"`` axis."""
        if name == "data":
            return self.data_group, self.data_rank, self.data_size
        if name == "model":
            return self.model_group, self.model_rank, self.model_size
        raise ValueError(f"unknown mesh axis '{name}'")


def check_backend(backend: str, device_type: str, ranks_on_host: int, device_count: int,
                  nccl_available: bool) -> None:
    """Raise where ``backend`` cannot run ``ranks_on_host`` ranks on devices
    of ``device_type`` of which the host has ``device_count``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend '{backend}': use one of {BACKENDS}")
    if backend != "nccl":
        return
    if device_type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device; use gloo on the CPU")
    if not nccl_available:
        raise RuntimeError("this PyTorch has no NCCL; use the gloo backend")
    if ranks_on_host > device_count:
        raise ValueError(
            f"{ranks_on_host} ranks on {device_count} CUDA device(s): NCCL refuses two ranks on one device; "
            "use the gloo backend for ranks that share a device"
        )


def _rank_device(device: Optional[str], local_rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def join(rank: int, world_size: int, init_method: str, backend: Optional[str] = None,
         device: Optional[str] = None, timeout: float = 120.0, local_rank: Optional[int] = None,
         ranks_on_host: Optional[int] = None) -> torch.device:
    """Join the process group at ``init_method`` as ``rank`` of
    ``world_size``; returns the rank's device. ``device`` as
    ``resolve_device`` takes it, a bare ``cuda`` meaning ``cuda:local_rank
    % device_count``; ``backend`` defaults to ``nccl`` on a CUDA device and
    ``gloo`` on the CPU (:func:`check_backend`; ``ranks_on_host`` defaults
    to ``world_size``). A rank that waits ``timeout`` seconds on another
    fails."""
    dev = _rank_device(device, rank if local_rank is None else local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    check_backend(backend, dev.type, world_size if ranks_on_host is None else ranks_on_host,
                  torch.cuda.device_count() if dev.type == "cuda" else 0, dist.is_nccl_available())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def _data_size(world_size: int, data_size: int, model_size: int) -> int:
    """The data axis of a ``data_size x model_size`` mesh (-1: what the
    model axis leaves); raises unless the shape covers ``world_size``."""
    if data_size == -1:
        data_size = world_size // model_size
    if data_size * model_size != world_size:
        raise ValueError(f"mesh shape ({data_size}, {model_size}) does not cover {world_size} ranks")
    return data_size


def make_mesh(device: torch.device, data_size: int = -1, model_size: int = 1, timeout: float = 120.0) -> Mesh:
    """A ``data x model`` mesh over the joined world (every rank calls it
    alike). ``data_size`` -1 is ``world // model_size``; ``data_size *
    model_size`` must be the world size, as JAX's ``make_mesh`` asks."""
    rank, world_size = dist.get_rank(), dist.get_world_size()
    data_size = _data_size(world_size, data_size, model_size)
    wait = datetime.timedelta(seconds=timeout)
    data_group = model_group = None
    # every rank creates every group, in one order
    for m in range(model_size):
        group = dist.new_group([d * model_size + m for d in range(data_size)], timeout=wait)
        if rank % model_size == m:
            data_group = group
    for d in range(data_size):
        group = dist.new_group([d * model_size + m for m in range(model_size)], timeout=wait)
        if rank // model_size == d:
            model_group = group
    return Mesh(rank, world_size, data_size, model_size, data_group, model_group, device, dist.get_backend())


def init_mesh(rank: int, world_size: int, init_method: str, data_size: int = -1, model_size: int = 1,
              backend: Optional[str] = None, device: Optional[str] = None, timeout: float = 120.0,
              local_rank: Optional[int] = None, ranks_on_host: Optional[int] = None) -> Mesh:
    """:func:`join`, then :func:`make_mesh`; a shape that does not cover
    the world raises before joining."""
    _data_size(world_size, data_size, model_size)
    dev = join(rank, world_size, init_method, backend, device, timeout, local_rank, ranks_on_host)
    return make_mesh(dev, data_size, model_size, timeout)


def join_from_env(backend: Optional[str] = None, device: Optional[str] = None, timeout: float = 300.0
                  ) -> torch.device:
    """:func:`join` from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and the store's
    ``MASTER_ADDR``/``MASTER_PORT``)."""
    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
    except KeyError as err:
        raise RuntimeError(f"--distributed needs torchrun's environment; {err.args[0]} is not set") from err
    ranks_on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return join(rank, world, "env://", backend, device, timeout, local_rank, ranks_on_host)


def init_mesh_from_env(data_size: int = -1, model_size: int = 1, backend: Optional[str] = None,
                       device: Optional[str] = None, timeout: float = 300.0) -> Mesh:
    """:func:`join_from_env`, then :func:`make_mesh`."""
    return make_mesh(join_from_env(backend, device, timeout), data_size, model_size, timeout)


def destroy_mesh() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def check_parallel(cfg, mesh) -> None:
    """Raise for a ``parallel`` group the run cannot take: a data axis
    other than -1 or the world size (1 without ``--distributed``), or a
    model axis (the CLIs shard rays, frames and scenes only)."""
    world = 1 if mesh is None else mesh.world_size
    if cfg.parallel.model_axis_size != 1:
        raise ValueError(f"parallel.model_axis_size={cfg.parallel.model_axis_size}: the CLIs run data-parallel "
                         "only; tensor parallelism is parallel.steps.make_sharded_train_step's")
    if cfg.parallel.data_axis_size not in (-1, world):
        hint = "" if mesh is not None else " (a data axis needs --distributed under torchrun)"
        raise ValueError(f"parallel.data_axis_size={cfg.parallel.data_axis_size} on {world} rank(s){hint}")


def layer_spec(name: str, fan_in: int, fan_out: int, model_size: int) -> Dict[str, Optional[int]]:
    """Which dimension of a linear layer's ``w`` and ``b`` shards over the
    model axis (None: replicated)."""
    if model_size > 1 and name in COLUMN_PARALLEL and fan_out % model_size == 0:
        return {"w": 1, "b": 0}
    if model_size > 1 and name in ROW_PARALLEL and fan_in % model_size == 0:
        return {"w": 0, "b": None}
    return {"w": None, "b": None}


def _replicated(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    return None


def nerf_param_spec(params: Dict[str, Any], model_size: int) -> Dict[str, Any]:
    """The tree of ``params`` (``{"coarse"|"fine": {layer: ...}}``, tensors
    or arrays) with, at each leaf, the dimension sharded over the model
    axis, or None (``nerf_param_spec`` of the JAX package, :62)."""

    def spec_for(name, layer):
        if not (isinstance(layer, dict) and "w" in layer):
            return _replicated(layer)
        fan_in, fan_out = int(layer["w"].shape[0]), int(layer["w"].shape[1])
        return layer_spec(name, fan_in, fan_out, model_size)

    return {branch: {name: spec_for(name, layer) for name, layer in tree.items()} for branch, tree in params.items()}


def _shard(t: torch.Tensor, dim: Optional[int], rank: int, size: int) -> torch.Tensor:
    if dim is None:
        return t
    width = t.shape[dim] // size
    return t.narrow(dim, rank * width, width)


def _map(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], spec[k]) for k in tree}
    return fn(tree, spec)


def shard_params_from_jax(tree: Any, model_size: int, model_rank: int, device=None, spec=None) -> Any:
    """JAX params (nested dicts of numpy arrays) -> one model rank's slices
    as float32 tensors: ``params_from_jax`` cut by :func:`nerf_param_spec`
    (or ``spec``)."""
    spec = nerf_param_spec(tree, model_size) if spec is None else spec
    return _map(lambda t, d: _shard(t, d, model_rank, model_size).contiguous(), params_from_jax(tree, device), spec)


def place_state(mesh: Mesh, state: train.TrainState, optim_cfg: train.OptimConfig, spec=None,
                axis: str = "model") -> train.TrainState:
    """Put a whole train state onto the mesh: rank 0's params, Adam's
    moments and step counts, the schedule and the step broadcast over the
    world, then each rank's slice along ``axis`` of every leaf whose
    ``spec`` (default :func:`nerf_param_spec` at the model size) names a
    dimension, with Adam's moments sliced as their params. Adam acts element
    by element, so one Adam a rank over its slices is Adam over the whole.
    Returns a new state; the one given is left as it was, broadcast."""
    spec = nerf_param_spec(state.params, mesh.model_size) if spec is None else spec
    group, rank, size = mesh.axis(axis)
    leaves, dims = train.parameter_list(state.params), train.parameter_list(spec)
    opt = state.optimizer.state_dict()
    moments = {i: {"step": float(st["step"])} for i, st in opt["state"].items()}
    meta = [state.step, state.scheduler.state_dict(), opt["param_groups"], moments]
    if mesh.world_size > 1:
        dist.broadcast_object_list(meta, src=0)
    step, sched, groups, moments = meta
    with torch.no_grad():
        for leaf in leaves:
            collectives.broadcast_(leaf)
        for i, st in moments.items():
            for key in ("exp_avg", "exp_avg_sq"):
                saved = opt["state"].get(i, {}).get(key)
                st[key] = collectives.broadcast_(saved if saved is not None else torch.zeros_like(leaves[i]))
    params = _map(lambda t, d: _shard(t.detach(), d, rank, size).clone().requires_grad_(True), state.params, spec)
    optimizer = train.make_optimizer(params, optim_cfg)
    optimizer.load_state_dict({
        "state": {i: {"step": torch.tensor(st["step"], dtype=torch.float32),
                      "exp_avg": _shard(st["exp_avg"], dims[i], rank, size).clone(),
                      "exp_avg_sq": _shard(st["exp_avg_sq"], dims[i], rank, size).clone()}
                  for i, st in moments.items()},
        "param_groups": groups,
    })
    scheduler = train.lr_schedule(optimizer, optim_cfg)
    scheduler.load_state_dict(sched)
    return train.TrainState(step=step, params=params, optimizer=optimizer, scheduler=scheduler)


def gather_state(mesh: Mesh, state: train.TrainState, spec=None, axis: str = "model") -> Tuple[Any, dict]:
    """The whole params and Adam state dict of a state placed by
    :func:`place_state` (the slices along ``axis`` gathered), on every rank:
    what a single-process run of the same state holds."""
    spec = nerf_param_spec(state.params, mesh.model_size) if spec is None else spec
    group = mesh.axis(axis)[0]

    def whole(t, dim):
        return t.detach() if dim is None else collectives.all_gather(t, group, dim)

    params = _map(whole, state.params, spec)
    dims = train.parameter_list(spec)
    opt = state.optimizer.state_dict()
    # new dicts: the state dict's per-param entries are the optimizer's own
    moments = {i: {**st, **{key: whole(st[key], dims[i]) for key in ("exp_avg", "exp_avg_sq")}}
               for i, st in opt["state"].items()}
    return params, {"state": moments, "param_groups": opt["param_groups"]}


def scene_spec(params: Dict[str, Any]) -> Any:
    """Every leaf of a stacked multi-scene tree sharded along its scene axis."""
    return _map(lambda t, d: 0, params, _replicated(params))

