"""Production meshes on ``torch.distributed`` (the reference's
``launch/mesh.py``).

Importing this module starts no process group; meshes are built on
demand from the default group, which the caller starts.  Single pod:
16x16 = 256 ranks ("data", "model").  Multi-pod: 2x16x16 = 512 ranks
("pod", "data", "model") -- the "pod" axis composes with "data" for
gradient reduction.  ``fake_world`` starts a default group of the
``fake`` backend (no communication: each collective returns at once),
which the dry run uses to build these meshes in one process.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16x16 or 2x16x16 ``DeviceMesh`` over the default group, which
    must hold exactly 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION[multi_pod]
    want = 1
    for s in shape:
        want *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} mesh needs a "
                           f"default group of {want} ranks, not {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def elastic_shape(n: int, model_parallel: int = 16) -> Tuple[int, int]:
    """``(data, model)`` of the largest mesh of ``n`` survivors: the
    model axis halves until it divides ``n``."""
    while model_parallel > 1 and n % model_parallel != 0:
        model_parallel //= 2
    return n // model_parallel, model_parallel


def make_elastic_mesh(ranks: Sequence[int], model_parallel: int = 16,
                      device_type: str = "cuda"):
    """Largest (data, model) ``DeviceMesh`` of the surviving ``ranks`` of
    the default group -- the elastic-rescale path after a node failure;
    ``checkpoint.manager.restore(..., shardings=)`` places a checkpoint
    on it."""
    from torch.distributed.device_mesh import DeviceMesh

    data, model = elastic_shape(len(ranks), model_parallel)
    grid = torch.tensor(list(ranks)[:data * model],
                        dtype=torch.int).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def _fake_backend() -> None:
    """Register the ``fake`` backend: ``torch.testing``'s module does so
    on import; without it, register ``FakeProcessGroup`` here."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
        return
    except ImportError:
        pass
    fake = getattr(torch._C._distributed_c10d, "FakeProcessGroup", None)
    if fake is None:
        raise RuntimeError("this PyTorch has no fake process group "
                           "(torch._C._distributed_c10d.FakeProcessGroup)")
    if "fake" not in dist.Backend.backend_list:
        dist.Backend.register_backend(
            "fake", lambda common, opts: fake._create_internal(
                common.group_rank, common.group_size, opts),
            extended_api=True, devices=["cpu", "cuda"])


class _Store(dist.Store):
    """A store that holds nothing: the fake group never reads one."""


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks on the ``fake``
    backend, this process rank 0, for the length of the block: meshes of
    any size build and DTensors place shards without a peer; every
    collective is issued (and can be counted) but moves nothing.  Raises
    if a default group already exists; the group is destroyed on exit,
    whatever happens inside."""
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    _fake_backend()
    dist.init_process_group("fake", store=_Store(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
