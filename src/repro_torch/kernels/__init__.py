"""Hand-written Hopper kernels of the port, one package per kernel.

Each ``kernels/<name>/`` holds ``ref.py`` (the plain PyTorch version),
``csrc/<name>.cu`` (the CUDA kernel, built by ``_build.py`` on first use) and
``ops.py`` (the wrapper: the kernel for CUDA tensors, the plain version for
CPU tensors).  The flash backward's source has a package of its own
(``flash_attention_bwd/csrc``), so that it builds apart; its wrapper and
plain version sit beside the forward's.  Headers that kernel sources share
(the flash kernels' TMA, mbarrier and ``wgmma`` helpers) live in
``kernels/include/``.  ``LAUNCHES`` counts each kernel's launches, so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

#: kernel launches per kernel name, bumped by each wrapper where it launches
LAUNCHES = {
    "bank_arbiter": 0,
    "banked_copy": 0,
    "paged_attention": 0,
    "paged_attention_merge": 0,
    "flash_attention": 0,
    "flash_attention_bwd": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_sms: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (a ``torch.device``),
    read once per device; the kernels size their grids by it."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]
