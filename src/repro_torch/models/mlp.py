"""Dense FFN blocks: SwiGLU (llama family) and biased GELU (whisper).

Weights keep the reference's layouts (``w_gate [d, f]``, ``w_down [f, d]``).
A serving model stores them in the compute dtype, cast once at load where the
reference casts per einsum; a training model keeps float32 master weights,
and each use casts to the activations' dtype (a no-op when they match).
Biases stay float32 and are cast per call, as there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.sharding_hooks import gather_sequence, whole_sequence_grad


def mlp_specs(cfg: ModelConfig, d_ff: int) -> dict:
    d = cfg.d_model
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": ParamSpec((d, d_ff), ("embed", "mlp"), init="fan_in"),
            "w_up": ParamSpec((d, d_ff), ("embed", "mlp"), init="fan_in"),
            "w_down": ParamSpec((d_ff, d), ("mlp", "embed"), init="fan_in"),
        }
    return {
        "w_in": ParamSpec((d, d_ff), ("embed", "mlp"), init="fan_in"),
        "b_in": ParamSpec((d_ff,), ("mlp",), init="zeros"),
        "w_out": ParamSpec((d_ff, d), ("mlp", "embed"), init="fan_in"),
        "b_out": ParamSpec((d,), (None,), init="zeros"),
    }


class MLP(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: int, dtype: torch.dtype):
        super().__init__()
        self.swiglu = cfg.mlp_type == "swiglu"
        for name, spec in mlp_specs(cfg, d_ff).items():
            dt = dtype if len(spec.shape) == 2 else torch.float32
            self.register_parameter(
                name, torch.nn.Parameter(torch.empty(spec.shape, dtype=dt), requires_grad=False)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gather_sequence(x)
        if self.swiglu:
            dt = x.dtype
            out = (F.silu(x @ self.w_gate.to(dt)) * (x @ self.w_up.to(dt))) @ self.w_down.to(dt)
            return whole_sequence_grad(out)
        h = F.gelu(x @ self.w_in.to(x.dtype) + self.b_in.to(x.dtype), approximate="tanh")
        return whole_sequence_grad(h @ self.w_out.to(x.dtype) + self.b_out.to(x.dtype))
