"""The fake process group the dry-run tests share: the production mesh
over a fake group of 256 ranks, as a module-scoped pytest fixture (import
``mesh`` into a test module), torn down after the module so that no other
test sees its process group or a sharding plan cached on its mesh."""

import pytest


def _clear_dtensor_caches():
    """Drop DTensor's cached sharding plans and redistribution steps.  They
    keep the mesh they were made on, and two meshes of one layout compare
    equal: a plan cached in one module would run the next module's
    collectives over the first module's destroyed groups."""
    import torch
    from torch.distributed.tensor import DTensor, _redistribute

    prop = DTensor._op_dispatcher.sharding_propagator
    for cached in (
        prop.propagate_op_sharding,
        prop._propagate_tensor_meta_cached,
        _redistribute._gen_transform_infos,
    ):
        cached.cache_clear()
    # the dispatch's native fast path keeps a cache of its own
    clear_native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if clear_native is not None:
        clear_native()


@pytest.fixture(scope="module")
def mesh():
    """The ``(16, 16)`` production mesh over a fake group of 256 ranks."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.sharding_hooks import set_activation_sharder

    dryrun.fake_world(256)
    yield make_production_mesh(device="cpu")
    set_activation_sharder(None)
    dist.destroy_process_group()
    _clear_dtensor_caches()
