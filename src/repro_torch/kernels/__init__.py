"""Hand-written Hopper kernels of the port, one package per kernel.

Each ``kernels/<name>/`` holds ``ref.py`` (the plain PyTorch version),
``csrc/<name>.cu`` (the CUDA kernel, built by ``_build.py`` on first use) and
``ops.py`` (the wrapper: the kernel for CUDA tensors, the plain version for
CPU tensors).  ``LAUNCHES`` counts each kernel's launches, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

#: kernel launches per kernel name, bumped by each wrapper where it launches
LAUNCHES = {
    "bank_arbiter": 0,
    "banked_copy": 0,
    "paged_attention": 0,
    "paged_attention_merge": 0,
    "flash_attention": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
